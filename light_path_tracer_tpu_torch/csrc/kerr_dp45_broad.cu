// The broad instances of the Kerr DP45 extras kernel: the spectral,
// flare-movie (thin, absorbed) and photon-ring order (thin, absorbed) forms
// with the width read at run time (kerr_broad_extras.cuh: what they
// compute, replace and what bounds them), entry lpt_kerr_dp45_broad. The
// siblings build the float64 (_f64), Kerr-Newman (_kn) and DOP853
// (kerr_dop853_broad*) instances; all of them form the lazily built "broad"
// library (ops/cuda/_build.py), so the other libraries build as before.

#include "kerr_broad_extras.cuh"

extern "C" {

// Launches the broad instance of call->form (0 spectral, 1 movie thin, 2
// movie absorbed, 3 orders thin, 4 orders absorbed) for `call` (an
// ExtrasCall of Real), the RiafParams of Real at `riaf` and the width at
// `broad` (a Broad of Real: width >= 1, its constants, monitor and
// workspace on the device); returns a cudaError_t (0 on success).
int LPT_ENTRY(lpt_kerr_dp45_broad)(const void* call, const void* riaf,
                                   const void* broad) {
  const ExtrasCall<Real>& C = *static_cast<const ExtrasCall<Real>*>(call);
  const Broad<Real>& B = *static_cast<const Broad<Real>*>(broad);
  if (B.width < 1) return static_cast<int>(cudaErrorInvalidValue);
  Prepared K;
  cudaError_t err;
  if (!begin(C, riaf, &K, &err)) return static_cast<int>(err);
  return BroadForms()(C.form, [&](auto tag) {
    return launch_broad<typename decltype(tag)::type>(C, K, B);
  });
}

// The resources of the broad instance of `form` on the current card into
// out[0..3] (describe in kerr_dp45_extras.cuh); a cudaError_t.
int LPT_ENTRY(lpt_kerr_dp45_broad_describe)(int form, int* out) {
  return BroadForms()(form, [&](auto tag) {
    return describe_broad<typename decltype(tag)::type>(out);
  });
}

#if !defined(LPT_DOUBLE) && !defined(LPT_KN) && !defined(LPT_DOP853)
// One a library: the broad library's.
const char* lpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif

}  // extern "C"
