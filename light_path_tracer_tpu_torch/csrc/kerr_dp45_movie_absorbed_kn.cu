// The Kerr-Newman instances of the self-absorbed flare-movie forms of the Kerr
// DP45 extras kernel (entries lpt_kerr_dp45_movie_absorbed_kn and its
// _describe twin): kerr_dp45_movie_absorbed.cu built with LPT_KN, so the
// geodesic and the flow carry the charge (kerr_dp45_extras.cuh). A translation
// unit of its own, so nvcc builds it beside the Kerr instances.

#define LPT_KN 1
#define LPT_INFIX _kn
#include "kerr_dp45_movie_absorbed.cu"
