// The broad instances of the Kerr extras kernel (kerr_dp45_extras.cuh), for
// Hopper (sm_90a): the spectral, flare-movie and photon-ring order forms
// with their width (bands, frames, orders) read at run time, for widths
// above the compiled instances' (8 bands, 8 frames, 4 orders). The sources
// kerr_dp45_broad.cu and its _f64, _kn and DOP853 siblings build them into
// the lazily built "broad" library (ops/cuda/_build.py).
//
// Replaces the Pallas TPU kernel
//   light_path_tracer_tpu/ops/pallas/volumetric_kernel.py::_extras_tile_kernel
//     (entries trace_rays_aux_pallas / trace_rays_spectral_pallas, built at
//     trace time for any n_extras)
// for the transfer functions of light_path_tracer_tpu/volumetric.py
// make_spectral_transfer, make_movie_transfer and make_order_transfer at
// any width. The plain PyTorch version is ops/kerr_trace.py
// trace_rays_spectral over light_path_tracer_tpu_torch/volumetric.py's
// transfers; the wrapper is ops/cuda/volumetric_kernel.py
// trace_rays_aux_cuda.
//
// What the design rests on: each wide component (a band's, a frame's or an
// order's intensity) is a quadrature of the rest of the state. Its slope
// depends on the five geodesic components and the leading extras (tau_hat;
// t [and tau]; m [and tau]) only, never on its own value or another wide
// component's:
//   spectral  dI_i = band_scale_i em exp(-c_i tau_hat)
//   movie     dI_k = weight (j + spot(t_k))
//   orders    dI_n = em where floor(max(m, 0)) is bucket n (the last open)
// so no stage argument of a wide component is ever read. The lane keeps the
// core (5 + 1 or 2 components) in registers and integrates it exactly as
// the narrow instances do, keeping from each stage's evaluation the few
// terms the wide slopes share (Ctx: em and tau_hat; weight, j, r^2 +
// spot_r^2, the cross term, phi and t; em and the bucket). Then, component
// by component in ascending order, it forms that component's stage slopes
// in registers from those terms, its solution and error sums, and adds its
// error term to the norm: component-outer, so a component costs four
// memory operations an attempt (its value and FSAL slope read, its
// solution and end slope written), where a stage-outer loop would keep the
// B and E sums in memory at about 24.
//
// Storage: the wide state lives in device memory, component-major as
// C.extras (component k of ray i at k n + i, so a warp's accesses
// coalesce), in two buffers of (value, slope) that swap on an accepted
// step: the attempt writes y5 and the end slope into the other buffer, and
// an accept without an event makes it the current one (FSAL). An event (at
// most once a ray: it ends the lane) rewrites the current values with the
// Hermite event point in a second pass and keeps the slope. Nothing caps
// the width but the workspace (4 W n scalars) the wrapper allocates.
//
// Numerics: every sum keeps the narrow instances' (and the plain loop's)
// order: the B sum, the E sum with E7 last, DOP853's B, E5 and E3 sums
// stage by stage and its running |k| maximum, and the error norm over the
// components in ascending order (the core first, then the wide ones). The
// norm's terms are formed before finite_ok is known; where it is false the
// sum is set to 0, which is what the narrow kernel's zeroed terms add up
// to. With -fmad=false a broad instance is then bitwise its narrow twin at
// every width both have, and bitwise the plain loop on the card.
//
// Per-width constants (the spectral -c_i and band scales, the frames'
// times) come from device arrays, formed in double on the host and rounded
// once as RiafParams's; the saturation monitor is a bit array over every
// extra (bit e of word e / 32).
//
// What bounds it: as the narrow forms, arithmetic and the slowest lane of
// each warp, plus the wide state's memory traffic (ops/cuda/bounds.py
// counts both).

#pragma once

#include "kerr_dp45_extras.cuh"

namespace {

// A launch's width: W wide components, the per-width constants (spectral:
// c0 = -c_i, c1 = the band scales; movie: c0 = the frame times), the
// monitor bits over all n_extras extras, and the workspace of 4 W n
// scalars (the value and slope rows of two buffers).
template <class T>
struct Broad {
  const T *c0, *c1;
  const unsigned int* monitor;
  T* work;
  int width;
};

static_assert(sizeof(Broad<float>) == 40, "Broad layout");
static_assert(sizeof(Broad<double>) == 40, "Broad64 layout");

__device__ __forceinline__ bool monitored(const unsigned int* mon, int e) {
  return (mon[e >> 5] >> (e & 31)) & 1u;
}

// (d tau_hat; dI_1..dI_W) of volumetric.make_spectral_transfer.
template <class T>
struct BroadSpectral {
  static constexpr int kLead = 1;
  static constexpr int kMinBlocks = kSingle<T> ? 4 : 3;
  struct Ctx {
    T em, tau_hat;
  };
  template <int Fam>
  __device__ __forceinline__ static Ctx eval(const T* y, Trig<T> tr, T p_t,
                                             T p_phi, const Params<T>& P,
                                             const RiafParams<T>& R, T* d) {
    const Source<T> s = source<Fam>(y, tr.c, p_t, p_phi, P, R);
    d[0] = R.geometry
               ? R.alpha0 * s.j
               : R.alpha0 * s.j * pow_(jmax(s.g, T(0.1)), R.q_minus_1);
    return Ctx{s.em, jmax(y[5], R.tau_floor)};
  }
  __device__ __forceinline__ static T slope(const Ctx& x,
                                            const RiafParams<T>&,
                                            const Broad<T>& B, int k) {
    return B.c1[k] * x.em * exp_(B.c0[k] * x.tau_hat);
  }
};

// (dt, [dtau,] dI_1..dI_W) of volumetric.make_movie_transfer
// (kerr_dp45_movie.cuh's Movie with the frames read at run time).
template <bool kAbsorbing, class T>
struct BroadMovie {
  static constexpr int kLead = 1 + (kAbsorbing ? 1 : 0);
  static constexpr int kMinBlocks = kSingle<T> ? 4 : 3;
  struct Ctx {
    T weight, j, rr, cross, phi, t;
  };
  template <int Fam>
  __device__ __forceinline__ static Ctx eval(const T* y, Trig<T> tr, T p_t,
                                             T p_phi, const Params<T>& P,
                                             const RiafParams<T>& R, T* d) {
    const T r = y[0];
    const T sin_th = tr.s, cos_th = tr.c;
    const Source<T> s = source<Fam>(y, cos_th, p_t, p_phi, P, R);
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
    return Ctx{weight, s.j, r2 + R.spot_r2, T(2.0) * r * R.spot_r * sin_th,
               y[2], y[5]};
  }
  __device__ __forceinline__ static T slope(const Ctx& x,
                                            const RiafParams<T>& R,
                                            const Broad<T>& B, int k) {
    const T phi_s = R.spot_phase + R.spot_omega * (B.c0[k] - x.t);
    const T d2 = x.rr - x.cross * cos_(x.phi - phi_s);
    const T spot = R.spot_amp * exp_(-d2 / R.two_spot_sig2);
    return x.weight * (x.j + spot);
  }
};

// (dm, [dtau,] dI_0..dI_{W-1}) of volumetric.make_order_transfer
// (kerr_dp45_orders.cu's Order with the orders read at run time).
template <bool kAbsorbing, class T>
struct BroadOrder {
  static constexpr int kLead = 1 + (kAbsorbing ? 1 : 0);
  static constexpr int kMinBlocks = kSingle<T> ? 4 : 3;
  struct Ctx {
    T em, bucket;
  };
  template <int Fam>
  __device__ __forceinline__ static Ctx eval(const T* y, Trig<T> tr, T p_t,
                                             T p_phi, const Params<T>& P,
                                             const RiafParams<T>& R, T* d) {
    const T r = y[0];
    const T c = tr.c;
    const Source<T> s = source<Fam>(y, c, p_t, p_phi, P, R);
    const T sigma_bl = r * r + R.a2 * c * c;
    d[0] = R.order_norm * exp_(-c * c * R.order_inv_two_sig2) *
           abs_(tr.s) * abs_(y[4]) / sigma_bl;
    const T bucket = floor_(jmax(y[5], T(0.0)));
    T em = s.em;
    if (kAbsorbing) {
      d[1] = opacity(s, R);
      em = em * exp_(-jmax(y[6], -T(30.0)));
    }
    return Ctx{em, bucket};
  }
  __device__ __forceinline__ static T slope(const Ctx& x,
                                            const RiafParams<T>&,
                                            const Broad<T>& B, int k) {
    const T edge = static_cast<T>(k);
    const bool in = k < B.width - 1 ? x.bucket == edge : x.bucket >= edge;
    return in ? x.em : T(0.0);
  }
};

// The core's right-hand side (the geodesic, then the leading extras) at
// state y; returns the terms the wide slopes share.
template <class F, int Fam, class T, int NC>
__device__ __forceinline__ typename F::Ctx rhs_core(const T (&y)[NC], T p_t,
                                                    T p_phi,
                                                    const Params<T>& P,
                                                    const RiafParams<T>& R,
                                                    T (&out)[NC]) {
  const Trig<T> tr{sin_(y[1]), cos_(y[1])};
  rhs5_trig<Fam>(y, tr.s, tr.c, p_t, p_phi, P, out);
  return F::template eval<Fam>(y, tr, p_t, p_phi, P, R, out + 5);
}

#ifdef LPT_DOP853
// The core's DOP853 attempt (kerr_dop853.cuh dop853_stages over the NC
// core components, each sum in the same order): y5, the end stage kend,
// the terms of stages 1..11 and of the end stage (x[0..11]) and the core's
// sums of squared scaled E5 and E3 errors, formed whether or not the
// attempt is finite (the caller zeroes them where it is not).
template <class F, int Fam, class T, int NC>
__device__ __forceinline__ void dop853_core(
    const T (&y)[NC], const T (&k1)[NC], T h, T atol, T rtol, T p_t,
    T p_phi, const Params<T>& P, const RiafParams<T>& R, T (&y5)[NC],
    T (&kend)[NC], typename F::Ctx (&x)[12], T& e5_sq, T& e3_sq,
    bool& finite_ok) {
  using K = Tab853<T>;
  T yt[NC], s1[NC], s2[NC], s3[NC], s4[NC], s5[NC], s6[NC], s7[NC], s8[NC],
      s9[NC], s10[NC], s11[NC];
  T bsum[NC], e5[NC], e3[NC], kmag[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    bsum[c] = K::b0 * k1[c];
    e5[c] = K::e5_0 * k1[c];
    e3[c] = K::e3_0 * k1[c];
    kmag[c] = abs_(k1[c]);
  }
  auto track = [&](const T (&s)[NC]) {
    if constexpr (kSingle<T>) {
#pragma unroll
      for (int c = 0; c < NC; ++c) kmag[c] = jmax(kmag[c], abs_(s[c]));
    }
  };
  auto add = [&](const T (&s)[NC], T b, T w5, T w3) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      bsum[c] = bsum[c] + b * s[c];
      e5[c] = e5[c] + w5 * s[c];
      e3[c] = e3[c] + w3 * s[c];
    }
    track(s);
  };
  auto rhs = [&](const T (&ys)[NC], T (&out)[NC]) {
    return rhs_core<F, Fam>(ys, p_t, p_phi, P, R, out);
  };
#pragma unroll
  for (int c = 0; c < NC; ++c) yt[c] = y[c] + h * (K::a1_0 * k1[c]);
  x[0] = rhs(yt, s1);
  track(s1);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a2_0 * k1[c] + K::a2_1 * s1[c]);
  x[1] = rhs(yt, s2);
  track(s2);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a3_0 * k1[c] + K::a3_2 * s2[c]);
  x[2] = rhs(yt, s3);
  track(s3);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a4_0 * k1[c] + K::a4_2 * s2[c] + K::a4_3 * s3[c]);
  x[3] = rhs(yt, s4);
  track(s4);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a5_0 * k1[c] + K::a5_3 * s3[c] + K::a5_4 * s4[c]);
  x[4] = rhs(yt, s5);
  add(s5, K::b5, K::e5_5, K::e3_5);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a6_0 * k1[c] + K::a6_3 * s3[c] + K::a6_4 * s4[c] +
                        K::a6_5 * s5[c]);
  x[5] = rhs(yt, s6);
  add(s6, K::b6, K::e5_6, K::e3_6);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a7_0 * k1[c] + K::a7_3 * s3[c] + K::a7_4 * s4[c] +
                        K::a7_5 * s5[c] + K::a7_6 * s6[c]);
  x[6] = rhs(yt, s7);
  add(s7, K::b7, K::e5_7, K::e3_7);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a8_0 * k1[c] + K::a8_3 * s3[c] + K::a8_4 * s4[c] +
                        K::a8_5 * s5[c] + K::a8_6 * s6[c] + K::a8_7 * s7[c]);
  x[7] = rhs(yt, s8);
  add(s8, K::b8, K::e5_8, K::e3_8);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a9_0 * k1[c] + K::a9_3 * s3[c] + K::a9_4 * s4[c] +
                        K::a9_5 * s5[c] + K::a9_6 * s6[c] + K::a9_7 * s7[c] +
                        K::a9_8 * s8[c]);
  x[8] = rhs(yt, s9);
  add(s9, K::b9, K::e5_9, K::e3_9);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a10_0 * k1[c] + K::a10_3 * s3[c] + K::a10_4 * s4[c] +
                        K::a10_5 * s5[c] + K::a10_6 * s6[c] + K::a10_7 * s7[c] +
                        K::a10_8 * s8[c] + K::a10_9 * s9[c]);
  x[9] = rhs(yt, s10);
  add(s10, K::b10, K::e5_10, K::e3_10);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    yt[c] = y[c] + h * (K::a11_0 * k1[c] + K::a11_3 * s3[c] + K::a11_4 * s4[c] +
                        K::a11_5 * s5[c] + K::a11_6 * s6[c] + K::a11_7 * s7[c] +
                        K::a11_8 * s8[c] + K::a11_9 * s9[c] +
                        K::a11_10 * s10[c]);
  x[10] = rhs(yt, s11);
  add(s11, K::b11, K::e5_11, K::e3_11);
#pragma unroll
  for (int c = 0; c < NC; ++c) y5[c] = y[c] + h * bsum[c];
  x[11] = rhs(y5, kend);
  finite_ok = all_finite(y5) && (y5[0] > T(0.0));

  e5_sq = T(0.0);
  e3_sq = T(0.0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    T mag = jmax(abs_(y[c]), abs_(y5[c]));
    if constexpr (kSingle<T>) mag = mag + h * jmax(kmag[c], abs_(kend[c]));
    const T scale = atol + rtol * mag;
    const T r5 = e5[c] / scale;
    const T r3 = e3[c] / scale;
    e5_sq = e5_sq + r5 * r5;
    e3_sq = e3_sq + r3 * r3;
  }
}
#endif

// The broad ray kernel of family Fam, one thread per ray: the narrow
// extras_kernel's loop over the core in registers, the wide components in
// device memory (see the head of this file).
template <class F, class T, int Fam>
__global__ void __launch_bounds__(kThreads, F::kMinBlocks)
LPT_KERNEL(broad_kernel)(ExtrasCall<T> C, Params<T> P, RiafParams<T> R,
                         SatParams<T> S, Broad<T> B) {
  using Ctx = typename F::Ctx;
  constexpr int NC = 5 + F::kLead;
  const int n = C.n;
  const int W = B.width;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0;

  if (i < n) {
    // Row `which` (0 value, 1 slope) of buffer `buf` at component k.
    auto at = [&](int buf, int which, int k) -> T& {
      return B.work[(static_cast<size_t>(2 * buf + which) * W + k) * n + i];
    };
    const RayStart<T> S0 = initial_state<Fam>(C.alpha[i], C.theta[i], P);
    const T p_t = S0.p_t, p_phi = S0.p_phi;
    const T r_capture = P.r_capture;
    const T r_escape = P.r_obs * T(2.0);
    const T lam_max = P.lambda_max;
    unsigned int lead_mon = 0;
#pragma unroll
    for (int e = 0; e < F::kLead; ++e)
      if (monitored(B.monitor, e)) lead_mon |= 1u << e;

    T y[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) y[c] = c < 5 ? S0.y[c] : T(0.0);
    T k1[NC];
    int cur = 0;
    {
      const Ctx x0 = rhs_core<F, Fam>(y, p_t, p_phi, P, R, k1);
      for (int k = 0; k < W; ++k) {
        at(cur, 0, k) = T(0.0);
        at(cur, 1, k) = F::slope(x0, R, B, k);
      }
    }
    T h = P.h_init;
    T lam = T(0.0);
    int status = S0.bad_obs ? kInvalid : kRunning;
    int sat_cnt = 0, frz_cnt = 0;
    unsigned int flags = 0;
    CycleWatch<T> watch;

    while (steps < P.max_steps && status == kRunning && lam < lam_max) {
      ++steps;
      const T h_eff = jmax(jmin(h, lam_max - lam), T(0.0));
      const int nxt = cur ^ 1;
      // the wide components' flags for an accept without an event (the
      // new state is then y5)
      bool w_any = false, w_moved = false, w_mon = false;
      bool finite_ok;
      T y5[NC], k7[NC];

#ifdef LPT_DOP853
      T err_norm;
      {
        using K = Tab853<T>;
        Ctx x[12];
        T e5_sq, e3_sq;
        dop853_core<F, Fam>(y, k1, h_eff, P.atol, P.rtol, p_t, p_phi, P, R,
                            y5, k7, x, e5_sq, e3_sq, finite_ok);
        for (int k = 0; k < W; ++k) {
          const T yk = at(cur, 0, k), k1k = at(cur, 1, k);
          T s[12];
#pragma unroll
          for (int j = 0; j < 12; ++j) s[j] = F::slope(x[j], R, B, k);
          T bsum = K::b0 * k1k, e5 = K::e5_0 * k1k, e3 = K::e3_0 * k1k;
          T kmag = abs_(k1k);
          if constexpr (kSingle<T>) {
#pragma unroll
            for (int j = 0; j < 4; ++j) kmag = jmax(kmag, abs_(s[j]));
          }
          const T bw[7] = {K::b5, K::b6, K::b7, K::b8, K::b9, K::b10, K::b11};
          const T w5[7] = {K::e5_5, K::e5_6, K::e5_7, K::e5_8,
                           K::e5_9, K::e5_10, K::e5_11};
          const T w3[7] = {K::e3_5, K::e3_6, K::e3_7, K::e3_8,
                           K::e3_9, K::e3_10, K::e3_11};
#pragma unroll
          for (int j = 0; j < 7; ++j) {
            bsum = bsum + bw[j] * s[4 + j];
            e5 = e5 + w5[j] * s[4 + j];
            e3 = e3 + w3[j] * s[4 + j];
            if constexpr (kSingle<T>) kmag = jmax(kmag, abs_(s[4 + j]));
          }
          const T y5k = yk + h_eff * bsum;
          const T kend = s[11];
          at(nxt, 0, k) = y5k;
          at(nxt, 1, k) = kend;
          finite_ok = finite_ok && is_finite_f(y5k);
          T mag = jmax(abs_(yk), abs_(y5k));
          if constexpr (kSingle<T>) mag = mag + h_eff * jmax(kmag, abs_(kend));
          const T scale = P.atol + P.rtol * mag;
          const T r5 = e5 / scale;
          const T r3 = e3 / scale;
          e5_sq = e5_sq + r5 * r5;
          e3_sq = e3_sq + r3 * r3;
          const bool d = y5k != yk;
          w_any = w_any || d;
          w_moved = w_moved || !same_bits(y5k, yk);
          w_mon = w_mon || (d && monitored(B.monitor, F::kLead + k));
        }
        if (!finite_ok) {
          e5_sq = T(0.0);
          e3_sq = T(0.0);
        }
        const T denom = e5_sq + T(0.01) * e3_sq;
        const T err = h_eff * e5_sq /
                      sqrt_(jmax(static_cast<T>(NC + W) * denom, T(1e-30)));
        err_norm = is_finite_f(err) ? err : inf_<T>();
      }
#else
      using K = Tab<T>;
      T k3[NC], k4[NC], k5[NC], k6[NC];
      Ctx x[5];  // the terms of stages 3..7
      {
        T yt[NC], k2[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) yt[c] = y[c] + h_eff * (K::A21 * k1[c]);
        rhs_core<F, Fam>(yt, p_t, p_phi, P, R, k2);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          yt[c] = y[c] + h_eff * (K::A31 * k1[c] + K::A32 * k2[c]);
        x[0] = rhs_core<F, Fam>(yt, p_t, p_phi, P, R, k3);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          yt[c] = y[c] + h_eff * (K::A41 * k1[c] + K::A42 * k2[c] +
                                  K::A43 * k3[c]);
        x[1] = rhs_core<F, Fam>(yt, p_t, p_phi, P, R, k4);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          yt[c] = y[c] + h_eff * (K::A51 * k1[c] + K::A52 * k2[c] +
                                  K::A53 * k3[c] + K::A54 * k4[c]);
        x[2] = rhs_core<F, Fam>(yt, p_t, p_phi, P, R, k5);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          yt[c] = y[c] + h_eff * (K::A61 * k1[c] + K::A62 * k2[c] +
                                  K::A63 * k3[c] + K::A64 * k4[c] +
                                  K::A65 * k5[c]);
        x[3] = rhs_core<F, Fam>(yt, p_t, p_phi, P, R, k6);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
        y5[c] = y[c] + h_eff * (K::B1 * k1[c] + K::B3 * k3[c] +
                                K::B4 * k4[c] + K::B5 * k5[c] +
                                K::B6 * k6[c]);
      x[4] = rhs_core<F, Fam>(y5, p_t, p_phi, P, R, k7);
      finite_ok = all_finite(y5) && (y5[0] > T(0.0));

      // the norm's terms, the core's then each wide component's (the wide
      // stage 2 slope enters neither the B nor the E sum)
      T err_sq = T(0.0);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const T scale = error_scale(y[c], y5[c], k1[c], k7[c], h_eff,
                                    P.atol, P.rtol);
        const T err = h_eff * (K::E1 * k1[c] + K::E3 * k3[c] +
                               K::E4 * k4[c] + K::E5 * k5[c] +
                               K::E6 * k6[c] + K::E7 * k7[c]);
        const T q = err / scale;
        err_sq = err_sq + q * q;
      }
      for (int k = 0; k < W; ++k) {
        const T yk = at(cur, 0, k), k1k = at(cur, 1, k);
        const T s3 = F::slope(x[0], R, B, k);
        const T s4 = F::slope(x[1], R, B, k);
        const T s5 = F::slope(x[2], R, B, k);
        const T s6 = F::slope(x[3], R, B, k);
        const T s7 = F::slope(x[4], R, B, k);
        const T y5k = yk + h_eff * (K::B1 * k1k + K::B3 * s3 + K::B4 * s4 +
                                    K::B5 * s5 + K::B6 * s6);
        at(nxt, 0, k) = y5k;
        at(nxt, 1, k) = s7;
        finite_ok = finite_ok && is_finite_f(y5k);
        const T scale =
            error_scale(yk, y5k, k1k, s7, h_eff, P.atol, P.rtol);
        const T err = h_eff * (K::E1 * k1k + K::E3 * s3 + K::E4 * s4 +
                               K::E5 * s5 + K::E6 * s6 + K::E7 * s7);
        const T q = err / scale;
        err_sq = err_sq + q * q;
        const bool d = y5k != yk;
        w_any = w_any || d;
        w_moved = w_moved || !same_bits(y5k, yk);
        w_mon = w_mon || (d && monitored(B.monitor, F::kLead + k));
      }
      if (!finite_ok) err_sq = T(0.0);
      const T err_norm = sqrt_(err_sq / static_cast<T>(NC + W));
#endif

      const bool accept = finite_ok && (err_norm <= T(1.0));
      const bool reject = finite_ok && (err_norm > T(1.0));
      const bool blowup = !finite_ok;

      // events on accepted steps, as the narrow kernel's
      const T r_prev = y[0], r_next = y5[0];
      const bool cap = accept && r_prev > r_capture && r_next <= r_capture;
      const bool esc =
          accept && r_prev < r_escape && r_next >= r_escape && !cap;
      const bool event = cap || esc;

      T frac = T(1.0);
      T h00 = T(0.0), h10 = T(0.0), h01 = T(0.0), h11 = T(0.0);
      T y_acc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) y_acc[c] = y5[c];
      if (event) {
        const T denom = r_next - r_prev;
        const T target = cap ? r_capture : r_escape;
        const T frac_lin =
            denom == T(0.0)
                ? T(1.0)
                : jclip((target - r_prev) / denom, T(0.0), T(1.0));
        frac = hermite_crossing_frac(r_prev, r_next, k1[0], k7[0], h_eff,
                                     target, frac_lin);
        const T s2 = frac * frac, s3 = s2 * frac;
        h00 = T(2.0) * s3 - T(3.0) * s2 + T(1.0);
        h10 = s3 - T(2.0) * s2 + frac;
        h01 = -T(2.0) * s3 + T(3.0) * s2;
        h11 = s3 - s2;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          y_acc[c] = h00 * y[c] + h10 * h_eff * k1[c] + h01 * y5[c] +
                     h11 * h_eff * k7[c];
      }

#ifdef LPT_DOP853
      const T factor = T(0.9) * pow_(jmax(err_norm, T(1e-30)), T(-0.125));
#else
      const T factor = T(0.9) * pow_(jmax(err_norm, T(1e-30)), T(-0.2));
#endif
      const T shrink = jmax(T(0.2), factor);
      const T grow = err_norm < P.tiny_err ? T(5.0) : jmin(T(5.0), factor);
      const T h_new = accept ? h * grow
                             : (reject ? h * shrink
                                       : (blowup ? h * T(0.25) : h));

      bool changed_mon = false, changed_any = false, moved = false;
      if (accept) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const bool d = y_acc[c] != y[c];
          changed_any = changed_any || d;
          moved = moved || !same_bits(y_acc[c], y[c]);
          if (c >= 5 && ((lead_mon >> (c - 5)) & 1u))
            changed_mon = changed_mon || d;
        }
        bool corrupt = !all_finite(y_acc);
        if (event) {
          // the wide components' event point, over the current buffer's
          // values; the slope stays (no FSAL after an event)
          for (int k = 0; k < W; ++k) {
            const T yk = at(cur, 0, k);
            const T ya = h00 * yk + h10 * h_eff * at(cur, 1, k) +
                         h01 * at(nxt, 0, k) + h11 * h_eff * at(nxt, 1, k);
            const bool d = ya != yk;
            changed_any = changed_any || d;
            moved = moved || !same_bits(ya, yk);
            if (monitored(B.monitor, F::kLead + k))
              changed_mon = changed_mon || d;
            corrupt = corrupt || !is_finite_f(ya);
            at(cur, 0, k) = ya;
          }
        } else {
          changed_any = changed_any || w_any;
          moved = moved || w_moved;
          changed_mon = changed_mon || w_mon;
          cur = nxt;  // y = y5, k1 = k7 (FSAL)
        }
        lam = lam + frac * h_eff;
#pragma unroll
        for (int c = 0; c < NC; ++c) y[c] = y_acc[c];
        if (!event) {
#pragma unroll
          for (int c = 0; c < NC; ++c) k1[c] = k7[c];
        }
        if (cap) status = kCaptured;
        else if (esc) status = kEscaped;
        if (corrupt) status = kInvalid;
      }
      if ((reject || blowup) && h_new < P.h_min) status = kInvalid;
      h = h_new;

      int adv = 1;
      if (watch.update(!moved, accept && !event, h, lam,
                       status == kRunning && lam < lam_max) &&
          C.cycle_exit) {
        adv = P.max_steps - steps + 1;
        if (S.window > 0) {
          adv = min(adv, S.window - frz_cnt);
          if (y[0] <= S.r_max) adv = min(adv, S.window - sat_cnt);
        }
        steps += adv - 1;
      }

      if (S.window > 0) {
        sat_cnt = changed_mon ? 0 : sat_cnt + adv;
        frz_cnt = changed_any ? 0 : frz_cnt + adv;
        if (status == kRunning)
          window_exit(S, sat_cnt, frz_cnt, y[0], lam_max, lam, flags);
      }
    }

    if (status == kRunning && lam < lam_max) flags |= 1u;
    const Final<T> Fin =
        finalize<Fam>(y, p_t, p_phi, status, C.r_reclass, P);
#pragma unroll
    for (int e = 0; e < F::kLead; ++e)
      C.extras[static_cast<size_t>(e) * n + i] =
          status == kInvalid ? T(0.0) : y[5 + e];
    for (int k = 0; k < W; ++k)
      C.extras[static_cast<size_t>(F::kLead + k) * n + i] =
          status == kInvalid ? T(0.0) : at(cur, 0, k);
    C.final_alpha[i] = Fin.alpha;
    C.n_half[i] = Fin.n_half;
    C.status[i] = Fin.status;
    C.flags[i] = static_cast<unsigned char>(flags);
    if (C.steps != nullptr) C.steps[i] = steps;
    if (C.census != nullptr) C.census[i] = watch.census();
  }

  const unsigned int warp_max =
      __reduce_max_sync(0xffffffffu, static_cast<unsigned int>(steps));
  if ((threadIdx.x & 31) == 0 && warp_max != 0)
    atomicAdd(C.warp_steps, static_cast<unsigned long long>(warp_max));
}

template <class F>
int launch_broad(const ExtrasCall<Real>& C, const Prepared& K,
                 const Broad<Real>& B) {
  LPT_KERNEL(broad_kernel)<F, Real, kExtrasFamily>
      <<<(C.n + kThreads - 1) / kThreads, kThreads, 0,
         static_cast<cudaStream_t>(C.stream)>>>(C, K.P, K.R, K.S, B);
  return static_cast<int>(cudaGetLastError());
}

// A broad instance's resources on the current card (describe in
// kerr_dp45_extras.cuh).
template <class F>
int describe_broad(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, LPT_KERNEL(broad_kernel)<F, Real, kExtrasFamily>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, LPT_KERNEL(broad_kernel)<F, Real, kExtrasFamily>, kThreads,
        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = F::kMinBlocks;
  return 0;
}

// The broad functors by form: 0 spectral, 1 movie thin, 2 movie absorbed,
// 3 orders thin, 4 orders absorbed.
struct BroadForms {
  template <class Fn>
  int operator()(int form, Fn&& fn) const {
    switch (form) {
      case 0: return fn(Tag<BroadSpectral<Real>>());
      case 1: return fn(Tag<BroadMovie<false, Real>>());
      case 2: return fn(Tag<BroadMovie<true, Real>>());
      case 3: return fn(Tag<BroadOrder<false, Real>>());
      case 4: return fn(Tag<BroadOrder<true, Real>>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

}  // namespace
