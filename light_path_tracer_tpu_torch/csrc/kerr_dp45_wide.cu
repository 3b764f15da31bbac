// The wide disk instances of the Kerr DP45 ray kernel: the disk variant of
// Kerr and Kerr-Newman with room for kWideSlots (8) crossing slots, with
// and without momentum, recording the launch's max_hits (5 to 8) at run
// time (entry lpt_kerr_dp45_wide). They replace
// light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py::trace_disk_rays_pallas
// with max_disk_hits above 4; see kerr_dp45.cu for what the kernel
// computes and what bounds it. A translation unit of its own, in the
// lazily built "more" library (ops/cuda/_build.py), so the DP45 library
// builds as before.

#define LPT_WIDE 1
#define LPT_INFIX _wide
#include "kerr_dp45.cu"
