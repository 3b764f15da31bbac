// The float64 mu-chart instances of the Kerr DP45 ray kernel (entry
// lpt_kerr_dp45_mu_f64): see kerr_dp45_mu.cu.

#define LPT_DOUBLE 1
#include "kerr_dp45_mu.cu"
