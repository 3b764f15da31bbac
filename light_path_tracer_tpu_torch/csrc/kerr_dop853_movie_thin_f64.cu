// The float64 DOP853 instances of the optically thin flare-movie forms of the
// Kerr extras kernel (entries lpt_kerr_dp45_movie_thin_dop853_f64): see
// kerr_dop853_movie_thin.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_movie_thin.cu"
