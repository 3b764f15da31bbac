// The float64 pow of the extras kernel's float64 instances
// (kerr_dp45_common.cuh pow_ under LPT_EXTERN_POW_F64): the math
// library's pow, built with nvcc's default contraction of a*b + c into
// FMA as PyTorch's CUDA build computes x ** y, where every other source of
// the package builds with -fmad=false. Not inlined: it is a translation
// unit of its own, linked into each library that holds float64 extras
// instances by relocatable device code (ops/cuda/_build.py).

#include <cuda_runtime.h>

__device__ __noinline__ double lpt_pow_f64(double x, double y) {
  return pow(x, y);
}
