// The float64 instance of the Schwarzschild / Reissner-Nordstrom RK4 orbit
// kernel (entry lpt_orbit_rk4_f64): see schwarzschild_rk4.cu. Its own
// translation unit, so nvcc builds it beside the float one.

#define LPT_DOUBLE 1
#include "schwarzschild_rk4.cu"
