// The broad plane-recorder instances of the Kerr DP45 ray kernel's disk
// variant: any number of planes of any kind (equatorial, flat tilted,
// warped) and the crossing-time recorder, Kerr and Kerr-Newman, the plane
// count and the slots a plane read at run time (kerr_planes.cuh with
// LPT_BROAD_PLANES; entry lpt_kerr_dp45_broad_planes). They replace what
// the JAX package runs on XLA beside
// light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py::trace_disk_rays_pallas
// for more than two planes (light_path_tracer_tpu/disk.py:306-316). A
// translation unit of its own, in the lazily built "broad" library
// (ops/cuda/_build.py).

#define LPT_PLANES 1
#define LPT_BROAD_PLANES 1
#define LPT_INFIX _broad_planes
#include "kerr_dp45.cu"
