// Schwarzschild / Reissner-Nordstrom fixed-step RK4 orbit kernel for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   light_path_tracer_tpu/ops/pallas/schwarzschild_kernel.py::_orbit_tile_kernel
//   (entry trace_rays_schwarzschild_pallas),
// written from what that kernel computes, not from its tiling. The plain
// PyTorch version is light_path_tracer_tpu_torch/ops/schwarzschild_trace.py
// (trace_rays_schwarzschild); the wrapper is
// ops/cuda/schwarzschild_kernel.py.
//
// Work: one CUDA thread per ray, 128 threads per block, grid =
// ceil(n/128). Each thread computes its ray's orbit initial state
// (u0 = 1/r_obs, w0 from the impact parameter, the sign of cos(alpha)
// picking the branch), runs fixed-step RK4 in phi on
//   (u', w') = (w, -u + 3 M u^2 [- 2 Q^2 u^3])
// with h = clip(phi_max - phi, 0, h_max) until the ray is captured
// (u crosses 1/(1.01 R_S)), escapes (u crosses 1/(2 r_obs)) or n_steps
// steps are spent, moving onto a crossing by the linear fraction of the
// step, and then extracts the final angle from the escape heading, the
// half-orbit count and the status fold. So one frame's trace is one
// launch: nothing is left for torch to do per ray. Each warp adds its
// largest per-ray step count to one int64 counter (the n_steps contract
// of ops/types.py); the per-ray counts are written too when asked for.
//
// What bounds it: arithmetic and the slowest lane of each warp. A step is
// four RHS evaluations of a few multiply-adds each, with no
// transcendental inside the loop, and a ray moves 4 bytes in and 13 out.
// Rays near the photon sphere wind up to phi_max (1000 steps) while sky
// rays escape in ~60, and a warp runs until its slowest lane is done; the
// raster order of an image grid keeps neighbours similar, which is all
// this first version does about it.
//
// Numerics follow the JAX package in the scalar type of the instance (this
// file builds the float one, schwarzschild_rk4_f64.cu the double one,
// entry lpt_orbit_rk4_f64): every constant is computed in double on the
// host (and rounded once to float in the float instance), operations
// keep JAX's association order ((3M u) u, (h/6) (k1 + 2k2 + 2k3 + k4)),
// the Schwarzschild and Reissner-Nordstrom initial states keep their own
// operation orders (template flag kCharged), jnp.maximum(x, 1e-300) keeps
// its literal (0 in float32, where it underflows), and max/min/clip
// propagate NaN as jnp's do. Build without --use_fast_math: phi reaches
// 50 rad, where __sinf/__cosf lose accuracy. The package builds with
// -fmad=false (ops/cuda/_build.py), so no a*b + c is contracted into an
// FMA and each product and sum rounds apart, as in the plain version;
// results still differ from it where the math libraries round sin or cos
// otherwise.

#include "kerr_dp45_common.cuh"

namespace {

template <class T>
struct OrbitParams {
  T r_obs;       // observer radius
  T sqrt_f0;     // sqrt(max(f(r_obs), 1e-300))
  T u0;          // 1 / r_obs
  T two_M;       // 2 M (float32 arithmetic on a float32 M in float)
  T q2;          // Q^2 (Reissner-Nordstrom initial state)
  T c3M;         // 3 M (orbit RHS)
  T c2Q2;        // 2 Q^2 (Reissner-Nordstrom orbit RHS)
  T u_capture;   // 1 / (1.01 R_S)
  T u_escape;    // 1 / (2 r_obs)
  T phi_max, h_max;
  T pi;          // the pi of the half-orbit count, in T
  T r_reclass;   // 1.1 R_S: escaped-like rays inside it are captured
  int n_steps;   // ceil(phi_max / h_max)
  int obs_invalid;  // f(r_obs) <= 0: the observer sits inside a horizon
};

// w' of the orbit equation (models/schwarzschild.py orbit_rhs and the
// Reissner-Nordstrom override).
template <bool kCharged, class T>
__device__ __forceinline__ T orbit_dw(T u, const OrbitParams<T>& P) {
  const T dw = -u + P.c3M * u * u;
  return kCharged ? dw - P.c2Q2 * u * u * u : dw;
}

// Fraction of the step at which prev -> nxt crosses target (_lerp_frac).
template <class T>
__device__ __forceinline__ T lerp_frac(T prev, T nxt, T target) {
  const T denom = nxt - prev;
  const T frac = denom == T(0.0) ? T(1.0) : (target - prev) / denom;
  return jclip(frac, T(0.0), T(1.0));
}

template <bool kCharged, class T>
__global__ void __launch_bounds__(kThreads)
orbit_rk4_kernel(const T* __restrict__ alpha,
                 T* __restrict__ final_alpha_out,
                 int* __restrict__ n_half_out, int* __restrict__ status_out,
                 int* __restrict__ steps_out,
                 unsigned long long* __restrict__ warp_steps_total, int n,
                 OrbitParams<T> P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0;
  // jnp.maximum(x, 1e-300): the literal rounds to 0 in float32
  const T tiny = T(1e-300);

  if (i < n) {
    // ---- initial state (orbit_initial_state) ----
    const T al = alpha[i];
    const T b = P.r_obs * sin_(al) / P.sqrt_f0;
    const T u0 = P.u0;
    const T b_safe = b == T(0.0) ? T(1.0) : b;
    T w0_sq;
    if (kCharged) {
      // 2 M u^3 - Q^2 u^4 with u^3 = u (u u), u^4 = (u u)(u u).
      const T u2 = u0 * u0;
      w0_sq = T(1.0) / (b_safe * b_safe) - u0 * u0 + P.two_M * (u0 * u2) -
              P.q2 * (u2 * u2);
    } else {
      w0_sq = T(1.0) / (b_safe * b_safe) - u0 * u0 + P.two_M * u0 * u0 * u0;
    }
    const bool invalid = P.obs_invalid != 0 || b == T(0.0) || w0_sq < T(0.0);
    const T w0 =
        (cos_(al) >= T(0.0) ? T(1.0) : -T(1.0)) * sqrt_(jmax(w0_sq, T(0.0)));

    // ---- fixed-step RK4 in phi with linear crossing events ----
    T u = u0, w = w0, phi = T(0.0);
    int status = invalid ? kInvalid : kRunning;
    while (steps < P.n_steps && status == kRunning) {
      ++steps;
      const T h = jmax(jmin(P.h_max, P.phi_max - phi), T(0.0));
      const T hh = T(0.5) * h;
      const T k1u = w;
      const T k1w = orbit_dw<kCharged>(u, P);
      const T k2u = w + hh * k1w;
      const T k2w = orbit_dw<kCharged>(u + hh * k1u, P);
      const T k3u = w + hh * k2w;
      const T k3w = orbit_dw<kCharged>(u + hh * k2u, P);
      const T k4u = w + h * k3w;
      const T k4w = orbit_dw<kCharged>(u + h * k3u, P);
      const T h6 = h / T(6.0);
      const T u_next = u + h6 * (k1u + T(2.0) * k2u + T(2.0) * k3u + k4u);
      const T w_next = w + h6 * (k1w + T(2.0) * k2w + T(2.0) * k3w + k4w);

      const bool cap = (u < P.u_capture) && (u_next >= P.u_capture);
      const bool esc = (u > P.u_escape) && (u_next <= P.u_escape) && !cap;
      const T frac = cap ? lerp_frac(u, u_next, P.u_capture)
                         : (esc ? lerp_frac(u, u_next, P.u_escape) : T(1.0));
      u = cap ? P.u_capture : (esc ? P.u_escape : u_next);
      w = w + frac * (w_next - w);
      phi = phi + frac * h;
      if (cap) status = kCaptured;
      else if (esc) status = kEscaped;
    }

    // ---- extraction (orbit_extract_angle) and the status fold ----
    const T r_f = T(1.0) / jmax(u, tiny);
    const int n_half = static_cast<int>(floor_(abs_(phi) / P.pi));
    const bool captured_by_radius = r_f <= P.r_reclass;
    const T dr_dphi = -w / jmax(u * u, tiny);
    const T sin_phi = sin_(phi), cos_phi = cos_(phi);
    const T heading = atan2_(dr_dphi * sin_phi + r_f * cos_phi,
                             dr_dphi * cos_phi - r_f * sin_phi);
    const T fa = acos_(jclip(-cos_(heading), -T(1.0), T(1.0)));

    const bool escaped_like = status == kEscaped || status == kRunning;
    const bool captured =
        status == kCaptured || (escaped_like && captured_by_radius);
    const int status_fold =
        status == kInvalid ? kInvalid : (captured ? kCaptured : kEscaped);
    final_alpha_out[i] = status_fold == kEscaped ? fa : quiet_nan<T>();
    n_half_out[i] = status == kInvalid ? 0 : n_half;
    status_out[i] = status_fold;
    if (steps_out != nullptr) steps_out[i] = steps;
  }

  // The warp's largest per-ray step count (lanes past n count 0).
  const unsigned int warp_max =
      __reduce_max_sync(0xffffffffu, static_cast<unsigned int>(steps));
  if ((threadIdx.x & 31) == 0 && warp_max != 0)
    atomicAdd(warp_steps_total, static_cast<unsigned long long>(warp_max));
}

}  // namespace

extern "C" {

// Zeroes the warp-step counter, launches the kernel on `stream` and
// returns the first CUDA error (0 on success). Pointers are device
// pointers (alpha and final_alpha_out of Real); steps_out may be null;
// charged selects the Reissner-Nordstrom form.
int LPT_ENTRY(lpt_orbit_rk4)(
    const void* alpha, void* final_alpha_out, void* n_half_out,
    void* status_out, void* steps_out, void* warp_steps_total, int n,
    int charged, Real r_obs, Real sqrt_f0, Real u0, Real two_M, Real q2,
    Real c3M, Real c2Q2, Real u_capture, Real u_escape, Real phi_max,
    Real h_max, Real pi, Real r_reclass, int n_steps, int obs_invalid,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(warp_steps_total, 0,
                                    sizeof(unsigned long long), s);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  OrbitParams<Real> P{r_obs,     sqrt_f0,  u0,        two_M,    q2,
                      c3M,       c2Q2,     u_capture, u_escape, phi_max,
                      h_max,     pi,       r_reclass, n_steps,  obs_invalid};
  const int blocks = (n + kThreads - 1) / kThreads;
  const Real* a = static_cast<const Real*>(alpha);
  Real* fa = static_cast<Real*>(final_alpha_out);
  int* nh = static_cast<int*>(n_half_out);
  int* st = static_cast<int*>(status_out);
  int* sp = static_cast<int*>(steps_out);
  unsigned long long* tot = static_cast<unsigned long long*>(warp_steps_total);
  if (charged)
    orbit_rk4_kernel<true, Real><<<blocks, kThreads, 0, s>>>(
        a, fa, nh, st, sp, tot, n, P);
  else
    orbit_rk4_kernel<false, Real><<<blocks, kThreads, 0, s>>>(
        a, fa, nh, st, sp, tot, n, P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
