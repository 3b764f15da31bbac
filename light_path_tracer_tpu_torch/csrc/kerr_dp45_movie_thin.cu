// The optically thin flare-movie forms of the Kerr DP45 extras kernel,
// extras (t, I_1..I_n) for n = 1..8 frames: see kerr_dp45_movie.cuh for
// what they compute, what they replace and what bounds them.

#include "kerr_dp45_movie.cuh"

extern "C" {

// Launches Movie<call->variant, false> for `call` (an ExtrasCall of
// Real, form 0) with the RiafParams of Real at `riaf`; returns a
// cudaError_t (0 on success).
int LPT_ENTRY(lpt_kerr_dp45_movie_thin)(const void* call,
                                        const void* riaf) {
  return run_entry(call, riaf, Frames<false>());
}

// The resources of Movie<variant, false> on the current card into out[0..3]
// (describe in kerr_dp45_extras.cuh); a cudaError_t.
int LPT_ENTRY(lpt_kerr_dp45_movie_thin_describe)(int form, int variant,
                                                 int* out) {
  return describe_entry(form, variant, out, Frames<false>());
}

}  // extern "C"
