// The self-absorbed flare-movie forms of the Kerr DP45 extras kernel,
// extras (t, tau, I_1..I_n) for n = 1..8 frames, the stationary base flow
// screening every frame through the shared optical depth: see
// kerr_dp45_movie.cuh for what they compute, what they replace and what
// bounds them.

#include "kerr_dp45_movie.cuh"

extern "C" {

// Launches Movie<call->variant, true> for `call` (an ExtrasCall of Real)
// with the RiafParams of Real at `riaf`; returns a cudaError_t (0 on success).
int LPT_ENTRY(lpt_kerr_dp45_movie_absorbed)(const void* call,
                                             const void* riaf) {
  return launch_movie<true>(call, riaf);
}

}  // extern "C"
