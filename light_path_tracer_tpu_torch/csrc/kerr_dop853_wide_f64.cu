// The float64 DOP853 wide disk instances of the Kerr ray kernel (entry
// lpt_kerr_dp45_wide_dop853_f64): see kerr_dop853_wide.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_wide.cu"
