// The float64 instances of the volumetric and spectral forms of the Kerr
// DP45 extras kernel (entry lpt_kerr_dp45_extras_f64): see
// kerr_dp45_extras.cu. Their own translation unit, so nvcc builds them
// beside the float ones.

#define LPT_DOUBLE 1
#include "kerr_dp45_extras.cu"
