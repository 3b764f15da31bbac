// The optically thin flare-movie forms of the Kerr DP45 extras kernel,
// extras (t, I_1..I_n) for n = 1..8 frames: see kerr_dp45_movie.cuh for
// what they compute, what they replace and what bounds them.

#include "kerr_dp45_movie.cuh"

extern "C" {

// Launches Movie<call->variant, false> for `call` (an ExtrasCall of Real)
// with the RiafParams of Real at `riaf`; returns a cudaError_t (0 on success).
int LPT_ENTRY(lpt_kerr_dp45_movie_thin)(const void* call, const void* riaf) {
  return launch_movie<false>(call, riaf);
}

}  // extern "C"
