// The float64 broad plane-recorder instances (entry
// lpt_kerr_dp45_broad_planes_f64): see kerr_dp45_broad_planes.cu;
// relocatable device code calling lpt_pow_f64.cu's pow (ops/cuda/_build.py).

#define LPT_DOUBLE 1
#include "kerr_dp45_broad_planes.cu"
