// The float64 wide disk instances of the Kerr DP45 ray kernel (entry
// lpt_kerr_dp45_wide_f64): see kerr_dp45_wide.cu.

#define LPT_DOUBLE 1
#include "kerr_dp45_wide.cu"
