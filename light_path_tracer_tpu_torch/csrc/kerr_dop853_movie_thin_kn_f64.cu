// The float64 DOP853 Kerr-Newman instances of the optically thin flare-movie
// forms of the extras kernel (entries lpt_kerr_dp45_movie_thin_kn_dop853_f64
// and its _describe twin): see kerr_dop853_movie_thin_kn.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_movie_thin_kn.cu"
