// The float64 DOP853 instances of the surface kernel (entry
// lpt_kerr_surface_dop853_f64): see kerr_surface.cu.

#define LPT_DOUBLE 1
#define LPT_DOP853 1
#include "kerr_surface.cu"
