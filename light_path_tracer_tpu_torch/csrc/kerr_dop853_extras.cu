// The DOP853 instances of the volumetric (thin, self-absorbed) and spectral
// forms of the Kerr extras kernel (kernels kerr_dop853_extras_kernel, entries
// lpt_kerr_dp45_extras_dop853 and its _describe twin): kerr_dp45_extras.cu
// built with Hairer's DOP853 8(5,3) pair of kerr_dop853.cuh, which replaces the
// method="dop853" branch of the Pallas extras kernels
// (light_path_tracer_tpu/ops/pallas/volumetric_kernel.py). Each functor keeps
// its DP45 twin's block bound. A translation unit of its own, linked into the
// DOP853 library (ops/cuda/_build.py).

#define LPT_DOP853 1
#include "kerr_dp45_extras.cu"
