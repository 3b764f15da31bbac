// The float64 DOP853 broad instances of the Kerr extras kernel (entry
// lpt_kerr_dp45_broad_dop853_f64): see kerr_dop853_broad.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_broad.cu"
