// The DOP853 broad instances of the Kerr extras kernel (kernels
// kerr_dop853_broad_kernel, entry lpt_kerr_dp45_broad_dop853):
// kerr_dp45_broad.cu with Hairer's DOP853 pair, whose core stages are
// kerr_broad_extras.cuh's dop853_core (kerr_dop853.cuh's order of sums).

#define LPT_DOP853 1
#include "kerr_dp45_broad.cu"
