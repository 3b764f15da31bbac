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
// What bounds it: the issue of library sequences and the slowest lane of
// each warp. An attempt makes 6 new RHS evaluations; each adds the
// emissivity (an exp) and the redshift (two pows, a sqrt and nine IEEE
// divisions) to the geodesic's sinf, cosf and three reciprocals, the cosf
// shared (ops/cuda/bounds.py counts every operation of every form). A ray
// reads 8 bytes and writes 4 (kExtras + 4) bytes (twice that in float64).
// The state, its seven stages and the counters live in registers, under
// each functor's block bound (chip_smoke.py prints every instance's
// registers, spills and blocks an SM).
// Each warp adds its largest per-ray attempt count to one int64 counter
// (the n_steps contract of ops/types.py). This file builds the float
// instances; kerr_dp45_extras_f64.cu the double ones (lpt_*_f64).

#include "kerr_dp45_extras.cuh"

namespace {

// dI = g^p j (ops/kerr_trace.py trace_rays_volumetric, optically thin).
template <class T>
struct VolThin {
  static constexpr int kExtras = 1;
  static constexpr int kAux = 0;
  static constexpr int kMinBlocks = kSingle<T> ? 6 : 7;
  template <int Fam>
  __device__ static void eval(const T* y, Trig<T> tr, T p_t, T p_phi,
                              const Params<T>& P, const RiafParams<T>& R,
                              const T*, T* d) {
    d[0] = source<Fam>(y, tr.c, p_t, p_phi, P, R).em;
  }
};

// dI = exp(-max(tau, -30)) g^p j, dtau = alpha0 j / max(g, 0.1).
template <class T>
struct VolAbsorbed {
  static constexpr int kExtras = 2;
  static constexpr int kAux = 0;
  static constexpr int kMinBlocks = kSingle<T> ? 6 : 7;
  template <int Fam>
  __device__ static void eval(const T* y, Trig<T> tr, T p_t, T p_phi,
                              const Params<T>& P, const RiafParams<T>& R,
                              const T*, T* d) {
    const Source<T> s = source<Fam>(y, tr.c, p_t, p_phi, P, R);
    d[0] = exp_(-jmax(y[6], T(-30.0))) * s.em;
    d[1] = opacity(s, R);
  }
};

// (d tau_hat, dI_1..dI_n) of volumetric.make_spectral_transfer.
template <int kBands, class T>
struct Spectral {
  static constexpr int kExtras = 1 + kBands;
  static constexpr int kAux = 0;
  static constexpr int kMinBlocks = kSingle<T> ? (kBands <= 3 ? 5 : 8) : 3;
  template <int Fam>
  __device__ static void eval(const T* y, Trig<T> tr, T p_t, T p_phi,
                              const Params<T>& P, const RiafParams<T>& R,
                              const T*, T* d) {
    const Source<T> s = source<Fam>(y, tr.c, p_t, p_phi, P, R);
    d[0] = R.geometry
               ? R.alpha0 * s.j
               : R.alpha0 * s.j * pow_(jmax(s.g, T(0.1)), R.q_minus_1);
    const T tau_hat = jmax(y[5], R.tau_floor);
#pragma unroll
    for (int b = 0; b < kBands; ++b)
      d[1 + b] = R.band_scale[b] * s.em * exp_(R.neg_c[b] * tau_hat);
  }
};

// The functors of this source by (form, variant): 0 thin, 1
// self-absorbed, 2 spectral with variant = the number of bands (1..8).
struct Forms {
  template <class Fn>
  int operator()(int form, int variant, Fn&& fn) const {
    switch (form == 2 ? 10 + variant : form) {
      case 0: return fn(Tag<VolThin<Real>>());
      case 1: return fn(Tag<VolAbsorbed<Real>>());
      case 11: return fn(Tag<Spectral<1, Real>>());
      case 12: return fn(Tag<Spectral<2, Real>>());
      case 13: return fn(Tag<Spectral<3, Real>>());
      case 14: return fn(Tag<Spectral<4, Real>>());
      case 15: return fn(Tag<Spectral<5, Real>>());
      case 16: return fn(Tag<Spectral<6, Real>>());
      case 17: return fn(Tag<Spectral<7, Real>>());
      case 18: return fn(Tag<Spectral<8, Real>>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

}  // namespace

extern "C" {

// Launches the extras kernel for `call` (an ExtrasCall of Real) with the
// RiafParams of Real at `riaf` (both host memory, copied into the launch)
// and returns a cudaError_t (0 on success). call->form: 0 thin (1 extra),
// 1 self-absorbed (2), 2 spectral (1 + variant extras, variant = the
// number of bands, 1..8).
int LPT_ENTRY(lpt_kerr_dp45_extras)(const void* call, const void* riaf) {
  return run_entry(call, riaf, Forms());
}

// The resources of the instance of (form, variant) on the current card
// into out[0..3] (describe in kerr_dp45_extras.cuh); a cudaError_t.
int LPT_ENTRY(lpt_kerr_dp45_extras_describe)(int form, int variant,
                                              int* out) {
  return describe_entry(form, variant, out, Forms());
}

}  // extern "C"
