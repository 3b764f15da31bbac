// The float64 DOP853 broad plane-recorder instances (entry
// lpt_kerr_dp45_broad_planes_dop853_f64): see kerr_dop853_broad_planes.cu.

#define LPT_DOUBLE 1
#include "kerr_dop853_broad_planes.cu"
