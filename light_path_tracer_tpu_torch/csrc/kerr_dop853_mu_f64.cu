// The float64 DOP853 mu-chart instances of the Kerr ray kernel (entry
// lpt_kerr_dp45_mu_dop853_f64): see kerr_dop853_mu.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_mu.cu"
