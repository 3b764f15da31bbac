// The mu = cos(theta) chart's instances of the Kerr DP45 ray kernel: the
// shadow variant of Kerr and Kerr-Newman integrating (r, mu, phi, p_r,
// p_mu) with the transcendental-free rhs5_mu (kerr_dp45_common.cuh), with
// the hybrid tracer's force_invalid mask (entry lpt_kerr_dp45_mu). They
// replace the formulation="mu" branch of
// light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py::_trace_tile_kernel
// (entry trace_rays_kerr_pallas); see kerr_dp45.cu for what the kernel
// computes and what bounds it. A translation unit of its own, so nvcc
// builds it beside the theta instances.

#define LPT_MU 1
#define LPT_INFIX _mu
#include "kerr_dp45.cu"
