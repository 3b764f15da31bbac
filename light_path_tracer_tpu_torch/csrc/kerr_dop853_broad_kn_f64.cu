// The float64 DOP853 Kerr-Newman broad instances of the extras kernel
// (entry lpt_kerr_dp45_broad_kn_dop853_f64): see kerr_dop853_broad_kn.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_broad_kn.cu"
