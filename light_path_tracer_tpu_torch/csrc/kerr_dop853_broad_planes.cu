// The DOP853 broad plane-recorder instances (entry
// lpt_kerr_dp45_broad_planes_dop853): kerr_dp45_broad_planes.cu with
// Hairer's pair (kerr_dop853.cuh).

#define LPT_DOP853 1
#include "kerr_dp45_broad_planes.cu"
