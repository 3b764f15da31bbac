// The volumetric (optically thin and self-absorbed) and multi-frequency
// spectral radiative transfer on the Kerr DP45 extras kernel
// (kerr_dp45_extras.cuh), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   light_path_tracer_tpu/ops/pallas/volumetric_kernel.py::_volumetric_tile_kernel
//     (entry trace_rays_volumetric_pallas), and
//   light_path_tracer_tpu/ops/pallas/volumetric_kernel.py::_extras_tile_kernel
//     (entry trace_rays_aux_pallas) for the spectral transfer function,
// written from what they compute, not from their tiling. The plain PyTorch
// versions are trace_rays_volumetric / trace_rays_spectral in
// light_path_tracer_tpu_torch/ops/kerr_trace.py, with the transfer
// functions of light_path_tracer_tpu_torch/volumetric.py; the wrappers are
// ops/cuda/volumetric_kernel.py.
//
// Work: one CUDA thread per ray, 128 threads per block. Each thread forms
// its ray's Bardeen initial conditions, runs its own adaptive DP45 + FSAL
// loop over the 5 + kExtras components (r, theta, phi, p_r, p_theta, then
// the path integrals), and extracts the escape angle, half-orbit count and
// status fold (models/kerr.py extract_angle, ops/kerr_trace.py
// finalize_angles) itself, so one launch leaves nothing per ray to torch.
// The extras derivative is a template functor: VolThin (I), VolAbsorbed
// (I, tau) and Spectral<kBands> (tau_hat, I_1..I_n, kBands 1..8). The
// emissivity profile (torus, powerlaw, shell, jet) and the flow (circular,
// or the jet's radial outflow) are one runtime switch each: they are the
// same for every ray of a launch, so the branch never diverges inside a
// warp, and four profiles times ten functors would otherwise be forty
// instances to build on every call.
//
// What bounds it: arithmetic and the slowest lane of each warp. An attempt
// makes 6 new RHS evaluations; each adds the emissivity (an exp, a pow and
// a cos) and the redshift (a pow, a sqrt and divisions) to the geodesic's
// sinf, cosf and three reciprocals. A ray reads 8 bytes and writes
// 4 (kExtras + 4) bytes. The state, its seven stages and the counters live
// in registers: ptxas for sm_90a reports 80 (VolThin) to 152 (kBands = 8,
// 14 components) registers a thread, with spills of 4-16 bytes in three
// instances and none at 8 bands (chip_smoke.py prints the report).
// Each warp adds its largest per-ray attempt count to one int64 counter
// (the n_steps contract of ops/types.py).

#include "kerr_dp45_extras.cuh"

namespace {

// dI = g^p j (ops/kerr_trace.py trace_rays_volumetric, optically thin).
struct VolThin {
  static constexpr int kExtras = 1;
  static constexpr int kAux = 0;
  __device__ static void eval(const float* y, float p_t, float p_phi,
                              const Params&, const RiafParams& R,
                              const float*, float* d) {
    d[0] = source(y, p_t, p_phi, R).em;
  }
};

// dI = exp(-max(tau, -30)) g^p j, dtau = alpha0 j / max(g, 0.1).
struct VolAbsorbed {
  static constexpr int kExtras = 2;
  static constexpr int kAux = 0;
  __device__ static void eval(const float* y, float p_t, float p_phi,
                              const Params&, const RiafParams& R,
                              const float*, float* d) {
    const Source s = source(y, p_t, p_phi, R);
    d[0] = expf(-jmax(y[6], -30.0f)) * s.em;
    d[1] = opacity(s, R);
  }
};

// (d tau_hat, dI_1..dI_n) of volumetric.make_spectral_transfer.
template <int kBands>
struct Spectral {
  static constexpr int kExtras = 1 + kBands;
  static constexpr int kAux = 0;
  __device__ static void eval(const float* y, float p_t, float p_phi,
                              const Params&, const RiafParams& R,
                              const float*, float* d) {
    const Source s = source(y, p_t, p_phi, R);
    d[0] = R.geometry ? R.alpha0 * s.j
                      : R.alpha0 * s.j * powf(jmax(s.g, 0.1f), R.q_minus_1);
    const float tau_hat = jmax(y[5], R.tau_floor);
#pragma unroll
    for (int b = 0; b < kBands; ++b)
      d[1 + b] = R.band_scale[b] * s.em * expf(R.neg_c[b] * tau_hat);
  }
};

}  // namespace

extern "C" {

// Launches the extras kernel for `call` (an ExtrasCall) with the
// RiafParams at `riaf` (both host memory, copied into the launch) and
// returns a cudaError_t (0 on success). call->form: 0 thin (1 extra),
// 1 self-absorbed (2), 2 spectral (1 + variant extras, variant = the
// number of bands, 1..8).
int lpt_kerr_dp45_extras(const void* call, const void* riaf) {
  const ExtrasCall& C = *static_cast<const ExtrasCall*>(call);
  Prepared K;
  cudaError_t err;
  if (!begin(C, riaf, &K, &err)) return static_cast<int>(err);
  switch (C.form == 2 ? 10 + C.variant : C.form) {
    case 0: launch<VolThin>(C, K); break;
    case 1: launch<VolAbsorbed>(C, K); break;
    case 11: launch<Spectral<1>>(C, K); break;
    case 12: launch<Spectral<2>>(C, K); break;
    case 13: launch<Spectral<3>>(C, K); break;
    case 14: launch<Spectral<4>>(C, K); break;
    case 15: launch<Spectral<5>>(C, K); break;
    case 16: launch<Spectral<6>>(C, K); break;
    case 17: launch<Spectral<7>>(C, K); break;
    case 18: launch<Spectral<8>>(C, K); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
