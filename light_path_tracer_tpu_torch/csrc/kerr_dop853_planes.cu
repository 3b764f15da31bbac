// The DOP853 plane-recorder instances (entry lpt_kerr_dp45_planes_dop853),
// kerr_dp45_planes.cu with Hairer's pair (kerr_dop853.cuh), in the DOP853
// library.

#define LPT_DOP853 1
#include "kerr_dp45_planes.cu"
