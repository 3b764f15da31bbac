// The float64 DOP853 plane-recorder instances (entry
// lpt_kerr_dp45_planes_dop853_f64).

#define LPT_DOUBLE 1
#include "kerr_dop853_planes.cu"
