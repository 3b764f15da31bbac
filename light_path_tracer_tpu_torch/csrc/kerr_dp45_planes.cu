// The plane-recorder instances of the Kerr DP45 ray kernel's disk variant
// (kerr_planes.cuh): tilted, warped and second disk planes and the
// crossing-time recorder, Kerr and Kerr-Newman, 1 to 8 slots a plane and
// momenta at run time (entry lpt_kerr_dp45_planes). They replace what the
// JAX package runs on XLA beside
// light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py::trace_disk_rays_pallas
// (see kerr_planes.cuh). A translation unit of its own, in the lazily
// built "more" library (ops/cuda/_build.py).

#define LPT_PLANES 1
#define LPT_INFIX _planes
#include "kerr_dp45.cu"
