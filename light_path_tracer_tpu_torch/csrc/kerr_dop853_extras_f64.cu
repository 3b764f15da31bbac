// The float64 DOP853 instances of the volumetric (thin, self-absorbed) and
// spectral forms of the Kerr extras kernel (entries
// lpt_kerr_dp45_extras_dop853_f64): see kerr_dop853_extras.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_extras.cu"
