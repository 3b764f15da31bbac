// The float64 Kerr-Newman broad instances of the DP45 extras kernel (entry
// lpt_kerr_dp45_broad_kn_f64): see kerr_dp45_broad_kn.cu.

#define LPT_DOUBLE 1
#include "kerr_dp45_broad_kn.cu"
