// The DOP853 instances of the Kerr ray kernel (shadow and disk variants,
// every metric family; kernels kerr_dop853_kernel, entry
// lpt_kerr_dp45_dop853): kerr_dp45.cu built with Hairer's DOP853 8(5,3)
// pair of kerr_dop853.cuh, which replaces the method="dop853" branch of
// light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py::_trace_tile_kernel
// (entries trace_rays_kerr_pallas and trace_disk_rays_pallas). See
// kerr_dp45.cu for what the kernel computes and what bounds it. A
// translation unit of its own, linked into the DOP853 library
// (ops/cuda/_build.py), so a DP45-only run does not build it.

#define LPT_DOP853 1
#include "kerr_dp45.cu"
