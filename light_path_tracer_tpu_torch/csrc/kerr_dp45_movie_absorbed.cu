// The self-absorbed flare-movie forms of the Kerr DP45 extras kernel,
// extras (t, tau, I_1..I_n) for n = 1..8 frames, the stationary base flow
// screening every frame through the shared optical depth: see
// kerr_dp45_movie.cuh for what they compute, what they replace and what
// bounds them.

#include "kerr_dp45_movie.cuh"

extern "C" {

// Launches Movie<call->variant, true> for `call` (an ExtrasCall of
// Real, form 1) with the RiafParams of Real at `riaf`; returns a
// cudaError_t (0 on success).
int LPT_ENTRY(lpt_kerr_dp45_movie_absorbed)(const void* call,
                                            const void* riaf) {
  return run_entry(call, riaf, Frames<true>());
}

// The resources of Movie<variant, true> on the current card into out[0..3]
// (describe in kerr_dp45_extras.cuh); a cudaError_t.
int LPT_ENTRY(lpt_kerr_dp45_movie_absorbed_describe)(int form, int variant,
                                                     int* out) {
  return describe_entry(form, variant, out, Frames<true>());
}

}  // extern "C"
