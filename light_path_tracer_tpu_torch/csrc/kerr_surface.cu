// The surface kernel's float32 DP45 instances (kerr_surface.cuh: what it
// computes, what it replaces, what bounds it) and the C entry point
// lpt_kerr_surface. kerr_surface_f64.cu, kerr_surface_dop853.cu and
// kerr_surface_dop853_f64.cu include this file for the float64 and DOP853
// instances (entries *_f64, *_dop853, *_dop853_f64), each its own
// translation unit of the "surface" library (ops/cuda/_build.py).

#include "kerr_surface.cuh"

extern "C" {

// Launches the instance of the call's family (kKerr, kKerrNewman,
// kJohannsenPsaltis), with the time component when call->record_time, for
// `call` (a SurfaceCall of this source's Real) on call->stream; returns a
// cudaError_t (0 on success).
int LPT_ENTRY(lpt_kerr_surface)(const void* call) {
  const SurfaceCall<Real>& C = *static_cast<const SurfaceCall<Real>*>(call);
  const Params<Real> P{C.M,        C.a,        C.r_plus,     C.r_obs,
                       C.theta_obs, C.lambda_max, C.max_steps, C.atol,
                       C.rtol,     C.atol,     C.rtol,       C.h_min,
                       C.tiny_err, C.h_init,   C.r_capture,  C.q2,
                       Real(0.0),  C.eps3,     C.r_freeze};
  if (C.record_time && C.t_hit == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaMemsetAsync(C.warp_steps, 0, sizeof(unsigned long long),
                      static_cast<cudaStream_t>(C.stream));
  if (err != cudaSuccess || C.n <= 0) return static_cast<int>(err);
  switch (C.family) {
    case kKerr: return launch_family<kKerr>(C, P);
    case kKerrNewman: return launch_family<kKerrNewman>(C, P);
    case kJohannsenPsaltis: return launch_family<kJohannsenPsaltis>(C, P);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#if !defined(LPT_DOUBLE) && !defined(LPT_DOP853)
// One a library: the "surface" library's.
const char* lpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif

}  // extern "C"
