// The float64 instances of the optically thin flare-movie forms of the
// Kerr DP45 extras kernel (entry lpt_kerr_dp45_movie_thin_f64): see
// kerr_dp45_movie_thin.cu. Their own translation unit, so nvcc builds
// them beside the float ones.

#define LPT_DOUBLE 1
#include "kerr_dp45_movie_thin.cu"
