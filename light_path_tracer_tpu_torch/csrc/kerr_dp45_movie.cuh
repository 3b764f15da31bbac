// The flare-movie transfer on the Kerr DP45 extras kernel
// (kerr_dp45_extras.cuh), for Hopper (sm_90a): every observer-time frame
// of an orbiting hot spot in one trace. kerr_dp45_movie_thin.cu and
// kerr_dp45_movie_absorbed.cu instantiate it without and with absorption,
// so the two halves of the family compile side by side.
//
// Replaces the Pallas TPU kernel
//   light_path_tracer_tpu/ops/pallas/volumetric_kernel.py::_extras_tile_kernel
//     (entry trace_rays_aux_pallas / trace_rays_spectral_pallas)
// for the transfer function of
//   light_path_tracer_tpu/volumetric.py::make_movie_transfer.
// The plain PyTorch version is ops/kerr_trace.py trace_rays_spectral over
// light_path_tracer_tpu_torch/volumetric.py make_movie_transfer; the
// wrapper is ops/cuda/volumetric_kernel.py trace_rays_aux_cuda.
//
// Extras (t, [tau,] I_1..I_n): the coordinate time from the camera
// integrates as an error-controlled component (dt/dlambda = g^tt p_t +
// g^tphi p_phi, models/kerr.py tdot), and frame k's emissivity adds the
// Gaussian blob at the retarded time t_k - t, co-rotating at spot_r:
//   dI_k = [exp(-max(tau, -30))] g^p (j + spot_amp exp(-d_k^2 / 2 sigma^2)),
//   d_k^2 = r^2 + R^2 - 2 r R sin(theta) cos(phi - phase - Omega (t_k - t)),
// with sin(theta) signed (the double-cover chart). The frame times are
// launch constants; kFrames is 1..8.
//
// What bounds it: arithmetic and registers. Each RHS adds a cosf, an
// expf and a division per frame to the thin form's work, six times an
// attempt (ops/cuda/bounds.py; sin and cos of theta come from the
// geodesic's evaluation), and the state has up to 15 components,
// each with its seven stages: under the functor's block bound the widest
// instances spill (chip_smoke.py prints registers, spills and blocks an
// SM). A ray reads 8 bytes and writes 4 (kExtras + 4).

#pragma once

#include "kerr_dp45_extras.cuh"

namespace {

template <int kFrames, bool kAbsorbing, class T>
struct Movie {
  static constexpr int kExtras = 1 + (kAbsorbing ? 1 : 0) + kFrames;
  static constexpr int kAux = 0;
  static constexpr int kMinBlocks =
      kSingle<T> ? (kAbsorbing ? 7 : (kFrames <= 5 ? 5 : 4))
                 : (kAbsorbing && kFrames > 5 ? 7 : 3);
  // Forced inline: the Kerr Movie<8> absorbed instance, the one with the
  // most spill traffic, changes its time with nvcc's code placement alone
  // at the same registers and spills (PERF.md §6).
  template <int Fam>
  __device__ __forceinline__ static void eval(const T* y, Trig<T> tr,
                                              T p_t, T p_phi,
                                              const Params<T>& P,
                                              const RiafParams<T>& R,
                                              const T*, T* d) {
    const T r = y[0], phi = y[2], t = y[5];
    const T sin_th = tr.s, cos_th = tr.c;
    const Source<T> s = source<Fam>(y, cos_th, p_t, p_phi, P, R);

    // dt/dlambda from the contravariant metric (models/kerr.py tdot;
    // Kerr-Newman's Delta and g^tphi carry Q^2, kerr_newman.py)
    const T sin2 = jmax(sin_th * sin_th, Consts<T>::kSin2Floor);
    const T r2 = r * r, a2 = P.a * P.a;
    const T Sigma = r2 + a2 * cos_th * cos_th;
    T Delta = r2 - T(2.0) * P.M * r + a2;
    if constexpr (Fam == kKerrNewman) Delta = Delta + P.q2;
    const T ra2 = r2 + a2;
    const T A = ra2 * ra2 - a2 * Delta * sin2;
    const T SD = Sigma * Delta;
    if constexpr (Fam == kKerrNewman)
      d[0] = -A / SD * p_t + -P.a * (T(2.0) * P.M * r - P.q2) / SD * p_phi;
    else
      d[0] = -A / SD * p_t + -T(2.0) * P.M * P.a * r / SD * p_phi;

    T weight = s.w;
    if (kAbsorbing) {
      d[1] = opacity(s, R);
      weight = exp_(-jmax(y[6], -T(30.0))) * s.w;
    }
    // the blob at each frame's retarded time
    const T rr = r2 + R.spot_r2;
    const T cross = T(2.0) * r * R.spot_r * sin_th;
#pragma unroll
    for (int k = 0; k < kFrames; ++k) {
      const T phi_s = R.spot_phase + R.spot_omega * (R.times[k] - t);
      const T d2 = rr - cross * cos_(phi - phi_s);
      const T spot = R.spot_amp * exp_(-d2 / R.two_spot_sig2);
      d[1 + (kAbsorbing ? 1 : 0) + k] = weight * (s.j + spot);
    }
  }
};

// The functors of one absorption mode by variant = the number of frames
// (1..8); the form is the absorption flag, which the entry point fixes.
template <bool kAbsorbing>
struct Frames {
  template <class Fn>
  int operator()(int form, int variant, Fn&& fn) const {
    if (form != (kAbsorbing ? 1 : 0))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (variant) {
      case 1: return fn(Tag<Movie<1, kAbsorbing, Real>>());
      case 2: return fn(Tag<Movie<2, kAbsorbing, Real>>());
      case 3: return fn(Tag<Movie<3, kAbsorbing, Real>>());
      case 4: return fn(Tag<Movie<4, kAbsorbing, Real>>());
      case 5: return fn(Tag<Movie<5, kAbsorbing, Real>>());
      case 6: return fn(Tag<Movie<6, kAbsorbing, Real>>());
      case 7: return fn(Tag<Movie<7, kAbsorbing, Real>>());
      case 8: return fn(Tag<Movie<8, kAbsorbing, Real>>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

}  // namespace
