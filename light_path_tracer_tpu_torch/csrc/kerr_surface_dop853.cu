// The float32 DOP853 instances of the surface kernel (kernels
// kerr_dop853_surface_kernel, entry lpt_kerr_surface_dop853): see
// kerr_surface.cu, built with Hairer's DOP853 8(5,3) pair of
// kerr_dop853.cuh.

#define LPT_DOP853 1
#include "kerr_surface.cu"
