// The float64 broad instances of the Kerr DP45 extras kernel (entry
// lpt_kerr_dp45_broad_f64): see kerr_dp45_broad.cu; relocatable device code
// calling lpt_pow_f64.cu's pow (ops/cuda/_build.py).

#define LPT_DOUBLE 1
#include "kerr_dp45_broad.cu"
