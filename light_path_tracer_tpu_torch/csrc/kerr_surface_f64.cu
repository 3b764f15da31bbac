// The float64 DP45 instances of the surface kernel (entry
// lpt_kerr_surface_f64): see kerr_surface.cu. Relocatable device code
// whose pow calls lpt_pow_f64 (ops/cuda/_build.py).

#define LPT_DOUBLE 1
#include "kerr_surface.cu"
