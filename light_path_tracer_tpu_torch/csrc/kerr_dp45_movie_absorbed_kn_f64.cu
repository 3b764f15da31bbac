// The float64 Kerr-Newman instances of the self-absorbed flare-movie forms of
// the Kerr DP45 extras kernel (entries lpt_kerr_dp45_movie_absorbed_kn_f64 and
// its _describe twin): see kerr_dp45_movie_absorbed_kn.cu.

#define LPT_DOUBLE 1
#include "kerr_dp45_movie_absorbed_kn.cu"
