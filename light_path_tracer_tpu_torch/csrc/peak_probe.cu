// Arithmetic peak-rate probe for Hopper (sm_90a): register-resident
// chains of FMA (float32, one chain or eight independent ones a thread,
// and float64), of mixed FMA / add / mul, of sinf, and of the operations
// the ray kernels issue as library sequences rather than single
// instructions (exp, pow, an IEEE division, sqrt, sin and cos, in float32
// and float64, eight independent chains a thread each), whose marginal
// time between two chain lengths gives the card's own rates: the
// yardstick the ray kernels' bounds are stated against
// (ops/cuda/bounds.py).
//
// Replaces the Pallas TPU kernel
//   scripts/roofline.py::_chain_kernel (entry _chain),
// which measures the same quantities on a TPU core. There a block of
// (512, 128) elements walks through VMEM and the grid runs in order on one
// core; here one thread owns one element, keeps its accumulators in
// registers for the whole chain, and 2^22 elements put about fifteen full
// waves of threads on the 132 SMs, so the FMA pipes' latency is hidden by
// the other warps of the SM. The plain PyTorch version is
// ops/cuda/peak_probe.py chain_plain (the same recurrence as a loop of
// tensor operations); the wrapper is ops/cuda/peak_probe.py chain_cuda.
//
// What bounds it: arithmetic alone, by construction. An element is read
// once and written once (8 or 16 bytes), against 2 k to 16 k operations.
// The multiplier and the addend are kernel arguments, so the compiler
// cannot fold the recurrence; the loop is unrolled eight times. The
// library-sequence chains are maps that stay in range (exp(-v), b^v with
// b = 1/2, b / v, sqrt(v), sin(v), cos(v) from v in (0, 1)), so every
// call takes the sequence the ray kernels take, without special cases.
// These are built as the package builds everything (no fast math, IEEE
// division and square root), so each is the same sequence the ray
// kernels run.
//
// The package builds every kernel with -fmad=false (no contraction of
// a*b + c), so each FMA of the chains below is written explicitly
// (fma_): it is the operation being timed, one rounding per step.

#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 128;

enum ProbeForm {
  kFma32 = 0, kFma64 = 1, kMix = 2, kSin = 3, kFma32x8 = 4,
  // eight chains a thread of one library sequence: float32, then float64
  kExp32x8 = 5, kPow32x8 = 6, kDiv32x8 = 7, kSqrt32x8 = 8, kSin32x8 = 9,
  kCos32x8 = 10, kExp64x8 = 11, kPow64x8 = 12, kDiv64x8 = 13,
  kSqrt64x8 = 14, kSin64x8 = 15, kCos64x8 = 16,
  // atan2(v, b), the plane recorder's in-plane azimuth
  kAtan232x8 = 17, kAtan264x8 = 18
};

// One fused multiply-add, rounded once, in float or double.
__device__ __forceinline__ float fma_(float x, float y, float z) {
  return fmaf(x, y, z);
}
__device__ __forceinline__ double fma_(double x, double y, double z) {
  return fma(x, y, z);
}

// v <- fma(v, a, b), k times: 2 k flops an element.
template <class F>
__global__ void __launch_bounds__(kProbeThreads)
fma_chain_kernel(const F* __restrict__ x, F* __restrict__ out, int n, int k,
                 F a, F b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  F v = x[i];
#pragma unroll 8
  for (int s = 0; s < k; ++s) v = fma_(v, a, b);
  out[i] = v;
}

// Eight independent FMA chains an element, started 0.01 apart, 16 k flops
// an element; their sum is stored: independent work inside a thread, where
// the single chain leaves every free dispatch slot to the SM's other warps.
__global__ void __launch_bounds__(kProbeThreads)
fma8_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                  int k, float a, float b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = x[i] + 0.01f * static_cast<float>(j);
#pragma unroll 4
  for (int s = 0; s < k; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fma_(v[j], a, b);
  }
  float acc = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) acc = acc + v[j];
  out[i] = acc;
}

// Eight independent accumulators an element: two FMA chains, three add
// chains and three mul chains, 10 k flops an element; their sum is stored.
__global__ void __launch_bounds__(kProbeThreads)
mix_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 int k, float a, float b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  float f1 = x0, f2 = x0 + 0.01f;
  float a1 = x0 + 0.02f, a2 = x0 + 0.03f, a3 = x0 + 0.04f;
  float m1 = x0 + 0.05f, m2 = x0 + 0.06f, m3 = x0 + 0.07f;
  const float c1 = b, c2 = 2.0f * b, c3 = 3.0f * b;
  const float d1 = a, d2 = a + 1e-8f, d3 = a + 2e-8f;
#pragma unroll 8
  for (int s = 0; s < k; ++s) {
    f1 = fma_(f1, a, b);
    f2 = fma_(f2, a, b);
    a1 = a1 + c1;
    a2 = a2 + c2;
    a3 = a3 + c3;
    m1 = m1 * d1;
    m2 = m2 * d2;
    m3 = m3 * d3;
  }
  out[i] = ((((((f1 + f2) + a1) + a2) + a3) + m1) + m2) + m3;
}

// The library sequences as the ray kernels call them (kerr_dp45_common.cuh
// has the same overloads), one step of each chain.
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float pow_(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float atan2_(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double atan2_(double y, double x) {
  return atan2(y, x);
}

struct ExpStep {
  template <class F> __device__ static F run(F v, F) { return exp_(-v); }
};
struct PowStep {
  template <class F> __device__ static F run(F v, F b) { return pow_(b, v); }
};
struct DivStep {
  template <class F> __device__ static F run(F v, F b) { return b / v; }
};
struct SqrtStep {
  template <class F> __device__ static F run(F v, F) { return sqrt_(v); }
};
struct SinStep {
  template <class F> __device__ static F run(F v, F) { return sin_(v); }
};
struct CosStep {
  template <class F> __device__ static F run(F v, F) { return cos_(v); }
};
struct Atan2Step {
  template <class F> __device__ static F run(F v, F b) {
    return atan2_(v, b);
  }
};

// Eight independent chains v <- Op(v, b) an element, started 0.01 apart,
// 8 k calls an element; their sum is stored.
template <class Op, class F>
__global__ void __launch_bounds__(kProbeThreads)
op8_chain_kernel(const F* __restrict__ x, F* __restrict__ out, int n, int k,
                 F b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  F v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = x[i] + F(0.01) * static_cast<F>(j);
#pragma unroll 1
  for (int s = 0; s < k; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = Op::run(v[j], b);
  }
  F acc = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) acc = acc + v[j];
  out[i] = acc;
}

struct Op8Launch {
  int blocks;
  cudaStream_t s;
  const void* x;
  void* out;
  int n, k;
  double b;
};

template <class Op, class F>
void launch_op8(const Op8Launch& L) {
  op8_chain_kernel<Op, F><<<L.blocks, kProbeThreads, 0, L.s>>>(
      static_cast<const F*>(L.x), static_cast<F*>(L.out), L.n, L.k,
      static_cast<F>(L.b));
}

// v <- sinf(v), k times.
__global__ void __launch_bounds__(kProbeThreads)
sin_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 8
  for (int s = 0; s < k; ++s) v = sinf(v);
  out[i] = v;
}

}  // namespace

extern "C" {

// Launches one chain of length k over n elements on `stream` and returns
// a cudaError_t (0 on success). form: 0 float32 FMA, 1 float64 FMA (x and
// out are double), 2 mixed, 3 sinf, 4 eight float32 FMA chains, 5..10
// eight float32 chains of exp(-v), b^v, b / v, sqrt(v), sin(v), cos(v),
// 11..16 the same in float64 (x and out are double), 17 and 18 eight
// chains of atan2(v, b) in float32 and float64. a and b are the
// multiplier and the addend of the FMA forms; b is the base of the power,
// the numerator of the division and atan2's second argument.
int lpt_peak_probe(int form, const void* x, void* out, int n, int k,
                   double a, double b, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kProbeThreads - 1) / kProbeThreads;
  const float af = static_cast<float>(a), bf = static_cast<float>(b);
  const Op8Launch L{blocks, s, x, out, n, k, b};
  switch (form) {
    case kFma32:
      fma_chain_kernel<float><<<blocks, kProbeThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), n, k, af,
          bf);
      break;
    case kFma64:
      fma_chain_kernel<double><<<blocks, kProbeThreads, 0, s>>>(
          static_cast<const double*>(x), static_cast<double*>(out), n, k, a,
          b);
      break;
    case kMix:
      mix_chain_kernel<<<blocks, kProbeThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), n, k, af,
          bf);
      break;
    case kFma32x8:
      fma8_chain_kernel<<<blocks, kProbeThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), n, k, af,
          bf);
      break;
    case kSin:
      sin_chain_kernel<<<blocks, kProbeThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), n, k);
      break;
    case kExp32x8: launch_op8<ExpStep, float>(L); break;
    case kPow32x8: launch_op8<PowStep, float>(L); break;
    case kDiv32x8: launch_op8<DivStep, float>(L); break;
    case kSqrt32x8: launch_op8<SqrtStep, float>(L); break;
    case kSin32x8: launch_op8<SinStep, float>(L); break;
    case kCos32x8: launch_op8<CosStep, float>(L); break;
    case kExp64x8: launch_op8<ExpStep, double>(L); break;
    case kPow64x8: launch_op8<PowStep, double>(L); break;
    case kDiv64x8: launch_op8<DivStep, double>(L); break;
    case kSqrt64x8: launch_op8<SqrtStep, double>(L); break;
    case kSin64x8: launch_op8<SinStep, double>(L); break;
    case kCos64x8: launch_op8<CosStep, double>(L); break;
    case kAtan232x8: launch_op8<Atan2Step, float>(L); break;
    case kAtan264x8: launch_op8<Atan2Step, double>(L); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
