// The Kerr adaptive Dormand-Prince 4(5) ray kernel with error-controlled
// extra state components, for Hopper (sm_90a): the part every transfer
// family shares. A family's source file (kerr_dp45_extras.cu: thin,
// self-absorbed, spectral; kerr_dp45_stokes.cu; kerr_dp45_movie_*.cu;
// kerr_dp45_orders.cu) defines its functors and one C entry point, so the
// families compile side by side; each has a *_f64.cu sibling that builds
// its float64 instances (kerr_dp45_common.cuh, LPT_DOUBLE).
//
// Here: the transfer constants (RiafParams), the rest-frame emissivity
// profiles and the emitter redshifts, the ray kernel (initial conditions,
// the adaptive DP45 + FSAL loop over 5 + kExtras components, the
// saturation and frozen-state exits, the exact-cycle exit, the angle
// extraction of kerr_dp45_common.cuh), and the launch helpers. A functor is
//   template <class T> struct F { static constexpr int kExtras, kAux,
//     kMinBlocks; template <int Fam> static void eval(y, tr, p_t, p_phi,
//     P, R, aux, d); }
// with d the kExtras derivatives at state y, tr the sine and cosine of
// y[1] (computed once an evaluation for the geodesic and the transfer
// function alike) and aux the ray's kAux per-ray constants (read once
// into registers).
//
// Storage: a thread holds its ray's state, its seven stages and its
// counters in registers. kMinBlocks, the second argument of the kernel's
// __launch_bounds__, is the number of 128-thread blocks an SM must be
// able to hold at once: it caps the registers a thread may use (65,536 /
// (128 kMinBlocks)) and so trades spills for occupancy. Each functor
// states it per scalar type (and width), as measured on the H100 at the
// widths the study times and carried to the widths between them (PERF.md
// §6 lists which); the stage values of the extras kept in shared memory
// instead were measured slower for every instance (PERF.md §6).
//
// Saturation and frozen-state exits (sat_window > 0, ops/kerr_trace.py
// dp45_integrate): a ray whose monitored extras have not changed for
// sat_window consecutive attempts while r <= sat_r_max, or whose whole
// state has not changed for sat_window attempts anywhere, ends with
// lambda = lambda_max. The test compares the accepted state with the old
// one value by value; a rejected attempt keeps the old registers
// untouched, so no rounding can make a frozen state look changed.
//
// Exact-cycle exit (kerr_dp45_common.cuh, CycleWatch): a lane frozen in an
// exact cycle of (h, lambda) would run its attempts unchanged until the
// first of the windows above or max_steps stopped it; the loop counts
// those attempts at once (call.cycle_exit = 1; 0 grinds them, for the
// bitwise check), so the outputs are the same.
//
// Numerics follow the JAX package in the scalar type of the instance (see
// kerr_dp45_common.cuh): every Python-float constant of the JAX transfer
// functions arrives here formed in double (the wrapper computes RiafParams
// in double; the float instance gets it rounded once), r^1.5 and g^p are
// pow, sigmoid is 1 / (1 + exp(-x)).
//
// Metric family: Kerr, or Kerr-Newman in the sources that define LPT_KN
// (kerr_dp45_extras_kn.cu, _movie_thin_kn, _movie_absorbed_kn, _orders_kn
// and their _f64 and DOP853 siblings; entries *_kn*): a template argument
// Fam of the kernel, handed to the geodesic (rhs5_trig, initial_state,
// finalize) and to the functor's eval, whose flow then takes W = 2Mr -
// Q^2 and Delta + Q^2, and the charged Keplerian Omega = +-x / (r^2 +- a
// x), x = sqrt(Mr - Q^2) (volumetric._profile_fns; disk.keplerian_omega),
// in place of kep_num / (r^1.5 + kep_add). The Kerr instances compile to
// the code they compiled to before the family existed. The Stokes form
// has no Kerr-Newman instances (the JAX package's polarized volumetric
// transfer is Kerr-only).
//
// Embedded pair: DP45 in the kerr_dp45_*.cu sources; the kerr_dop853_*.cu
// sources include their DP45 siblings with LPT_DOP853 and build every
// functor with Hairer's DOP853 instead (kerr_dop853.cuh: 12 RHS
// evaluations an attempt, the same error control over all N components,
// kernels kerr_dop853_extras_kernel, entries *_dop853 and *_dop853_f64),
// each instance under its DP45 twin's block bound. Events are Hermite in
// both, as in the JAX package's volumetric traces.

#pragma once

#include "kerr_dp45_common.cuh"
#include "kerr_dop853.cuh"

namespace {

constexpr int kMaxBands = 8;
constexpr int kMaxFrames = 8;
constexpr int kMaxAux = 4;

#ifdef LPT_KN
constexpr int kExtrasFamily = kKerrNewman;
#else
constexpr int kExtrasFamily = kKerr;
#endif

enum Profile { kTorus = 0, kPowerlaw = 1, kShell = 2, kJet = 3 };
enum Field { kVertical = 0, kToroidal = 1, kRadial = 2 };

// The transfer function's constants (volumetric.py), each formed in
// double on the host (and rounded once in the float instance).
template <class T>
struct RiafParams {
  int profile;     // Profile
  int geometry;    // 1: g_power == 0, path length only (no redshift)
  T two_M, a, a2;       // 2 M, a, a^2
  // Omega_K = kep_num / (r^1.5 + kep_add); Kerr-Newman: kep_num x /
  // (r^2 + kep_add x) with kep_num = +-1, kep_add = +-a
  T kep_num, kep_add;
  T r_peak, two_sig_r2, two_h2, index;
  T shell_in, shell_out, edge_width;
  T jet_cos, two_jet_sig2, jet_r_base, jet_beta, jet_gamma;
  T g_power, alpha0;
  T q_minus_1, tau_floor;  // spectral: g^(q-1), the tau_hat floor
  T neg_c[kMaxBands];      // spectral: -f_i^(1-q)
  T band_scale[kMaxBands]; // spectral: f_i^-s
  // movie: the blob's peak, phase, Omega_K(spot_r), spot_r, spot_r^2 and
  // 2 sigma^2, and the frames' observer times
  T spot_amp, spot_phase, spot_omega, spot_r, spot_r2, two_spot_sig2;
  T times[kMaxFrames];
  // order decomposition: the crossing bump's norm and 1 / (2 sigma^2)
  T order_norm, order_inv_two_sig2;
  // Stokes: the field geometry (Field), 2 M a, 2 M a^2, the flow's sense
  // (+-1) and the polarization fraction of an emission element
  int field;
  T two_Ma, two_Ma2, flow_sign, p0;
};

// The saturation and frozen-state exits: off when window == 0; monitor is
// a bit mask over the extras.
template <class T>
struct SatParams {
  int window;
  unsigned int monitor;
  T r_max;
};

template <class T>
__device__ __forceinline__ T sigmoid_f(T x) {
  return T(1.0) / (T(1.0) + exp_(-x));
}

// Rest-frame emissivity j(r, cos theta) (volumetric._profile_fns).
template <class T>
__device__ __forceinline__ T j_rest(T r, T c, const RiafParams<T>& R) {
  switch (R.profile) {
    case kTorus: {
      const T d = r - R.r_peak;
      return exp_(-(d * d) / R.two_sig_r2 - c * c / R.two_h2);
    }
    case kPowerlaw:
      return pow_(jmax(r, T(1e-3)) / R.r_peak, R.index) *
             exp_(-c * c / R.two_h2);
    case kJet: {
      const T d = abs_(c) - R.jet_cos;
      return exp_(-(d * d) / R.two_jet_sig2) *
             pow_(jmax(r, T(1e-3)) / R.r_peak, R.index) *
             sigmoid_f((r - R.jet_r_base) / R.edge_width);
    }
    default:
      return sigmoid_f((r - R.shell_in) / R.edge_width) *
             sigmoid_f((R.shell_out - r) / R.edge_width);
  }
}

// The family's g^tphi numerator W = 2Mr (Kerr-Newman: 2Mr - Q^2) and
// Delta = r^2 - 2Mr + a^2 (+ Q^2), and the Keplerian angular velocity of
// the flow at r (disk.keplerian_omega).
template <int Fam, class T>
__device__ __forceinline__ T flow_W(T r, const Params<T>& P,
                                    const RiafParams<T>& R) {
  if constexpr (Fam == kKerrNewman) return R.two_M * r - P.q2;
  else return R.two_M * r;
}

template <int Fam, class T>
__device__ __forceinline__ T flow_Delta(T r, const Params<T>& P,
                                        const RiafParams<T>& R) {
  if constexpr (Fam == kKerrNewman)
    return r * r - R.two_M * r + R.a2 + P.q2;
  else return r * r - R.two_M * r + R.a2;
}

template <int Fam, class T>
__device__ __forceinline__ T kepler_omega(T r, const Params<T>& P,
                                          const RiafParams<T>& R) {
  if constexpr (Fam == kKerrNewman) {
    const T x = sqrt_(jmax(P.M * r - P.q2, T(0.0)));
    return R.kep_num * x / (r * r + R.kep_add * x);
  } else {
    return R.kep_num / (pow_(r, T(1.5)) + R.kep_add);
  }
}

// Circular-emitter redshift g = nu_obs / nu_em off the plane, clipped to
// [0, 10]: Keplerian where that orbit is timelike, ZAMO inside.
template <int Fam, class T>
__device__ __forceinline__ T g_circular(T r, T c, T p_t, T p_phi,
                                        const Params<T>& P,
                                        const RiafParams<T>& R) {
  const T s2 = jmax(T(1.0) - c * c, T(1e-12));
  const T W = flow_W<Fam>(r, P, R);
  const T Delta = flow_Delta<Fam>(r, P, R);
  const T ra2 = r * r + R.a2;
  const T A = ra2 * ra2 - R.a2 * Delta * s2;
  // covariant t-phi block (disk.covariant_tphi_components)
  const T Sigma = r * r + R.a2 * c * c;
  const T g_tt = -(T(1.0) - W / Sigma);
  const T g_tph = -R.a * W * s2 / Sigma;
  const T g_pp = (ra2 + R.a2 * W * s2 / Sigma) * s2;
  const T om_k = kepler_omega<Fam>(r, P, R);
  const T om_z = R.a * W / jmax(A, T(1e-30));
  const T tl_k = -(g_tt + T(2.0) * om_k * g_tph + om_k * om_k * g_pp);
  const T om = tl_k > T(1e-3) ? om_k : om_z;
  const T den =
      jmax(-(g_tt + T(2.0) * om * g_tph + om * om * g_pp), T(1e-12));
  const T xi = p_phi / jmax(-p_t, T(1e-30));
  const T g = sqrt_(den) / jmax(T(1.0) - om * xi, T(1e-3));
  return jclip(g, T(0.0), T(10.0));
}

// Redshift of the jet's emitter, moving radially outward at jet_beta in
// the ZAMO frame (p_r is the traced radial momentum), clipped to [0, 10].
template <int Fam, class T>
__device__ __forceinline__ T g_jet(T r, T c, T p_r, T p_t, T p_phi,
                                   const Params<T>& P,
                                   const RiafParams<T>& R) {
  const T s2 = jmax(T(1.0) - c * c, T(1e-12));
  const T W = flow_W<Fam>(r, P, R);
  const T Delta = jmax(flow_Delta<Fam>(r, P, R), T(1e-12));
  const T Sigma = jmax(r * r + R.a2 * c * c, T(1e-12));
  const T ra2 = r * r + R.a2;
  const T A = jmax(ra2 * ra2 - R.a2 * Delta * s2, T(1e-30));
  const T om = R.a * W / A;
  const T alpha_lapse = sqrt_(Sigma * Delta / A);
  const T e_inv = jmax(-p_t, T(1e-30));
  const T xi = p_phi / e_inv;
  const T inv_g =
      R.jet_gamma * ((T(1.0) - om * xi) / jmax(alpha_lapse, T(1e-6)) +
                     R.jet_beta * sqrt_(Delta / Sigma) * p_r / e_inv);
  const T g = T(1.0) / jmax(inv_g, T(0.1));
  return jclip(g, T(0.0), T(10.0));
}

// The rest-frame emissivity j, the emitter redshift g, the redshift
// weight w = g^p and the emission em = j w at state y with c = cos(y[1])
// in family Fam's flow; g and w are 1 in the pure-geometry mode.
template <class T>
struct Source {
  T j, g, w, em;
};

template <int Fam, class T>
__device__ __forceinline__ Source<T> source(const T* y, T c, T p_t, T p_phi,
                                            const Params<T>& P,
                                            const RiafParams<T>& R) {
  Source<T> s;
  s.j = j_rest(y[0], c, R);
  if (R.geometry) {
    s.g = T(1.0);
    s.w = T(1.0);
    s.em = s.j;
  } else {
    s.g = R.profile == kJet ? g_jet<Fam>(y[0], c, y[3], p_t, p_phi, P, R)
                            : g_circular<Fam>(y[0], c, p_t, p_phi, P, R);
    s.w = pow_(s.g, R.g_power);
    s.em = s.j * s.w;
  }
  return s;
}

// The invariant opacity chi = alpha0 j / max(g, 0.1) (alpha0 j in the
// pure-geometry mode) of the single-band, movie and order forms.
template <class T>
__device__ __forceinline__ T opacity(const Source<T>& s,
                                     const RiafParams<T>& R) {
  return R.geometry ? R.alpha0 * s.j : R.alpha0 * s.j / jmax(s.g, T(0.1));
}

// sin(theta) and cos(theta) of the state an evaluation runs at.
template <class T>
struct Trig {
  T s, c;
};

// The full right-hand side of family Fam: the geodesic's five
// components, then the functor's extras. aux holds the ray's F::kAux
// per-ray constants.
template <class F, int Fam, class T, int N>
__device__ __forceinline__ void rhs_full(const T (&y)[N], T p_t, T p_phi,
                                         const Params<T>& P,
                                         const RiafParams<T>& R,
                                         const T* aux, T (&out)[N]) {
  const Trig<T> tr{sin_(y[1]), cos_(y[1])};
  rhs5_trig<Fam>(y, tr.s, tr.c, p_t, p_phi, P, out);
  F::template eval<Fam>(y, tr, p_t, p_phi, P, R, aux, out + 5);
}

// One call of a C entry point, filled by the Python wrapper
// (ops/cuda/volumetric_kernel.py ExtrasCall and ExtrasCall64, field for
// field): device pointers, the stream, and the launch's scalars. aux[k] is
// the k-th per-ray constant (null where the functor takes fewer); extras
// is (kExtras, n) of T, each extra zeroed where the integration went
// INVALID; flags bit 0 is "unconverged" (still RUNNING with lambda budget
// left: the two-pass drivers re-trace it), bit 1 the saturation exit,
// bit 2 the frozen-state exit; steps (the per-ray attempts) and census
// (CycleWatch::census) may be null; warp_steps is one int64, zeroed before
// the launch. form and variant pick the functor within a source file;
// cycle_exit = 0 grinds exact cycles instead of counting them; family is
// the metric family (kKerr, or kKerrNewman for the *_kn entries) and q2
// Kerr-Newman's Q^2.
template <class T>
struct ExtrasCall {
  const T *alpha, *theta;
  const T* aux[kMaxAux];
  T *extras, *final_alpha;
  int *n_half, *status, *steps, *census;
  unsigned char* flags;
  unsigned long long* warp_steps;
  void* stream;
  int n, form, variant, max_steps, sat_window;
  unsigned int sat_monitor;
  int cycle_exit, family;
  T M, a, r_plus, r_obs, theta_obs, lambda_max, atol, rtol, h_min,
      tiny_err, h_init, r_capture, r_reclass, sat_r_max, q2;
};

// The wrapper mirrors both structs with ctypes (natural alignment:
// pointers first, then the 4-byte members, then the scalars of T).
static_assert(sizeof(RiafParams<float>) == 240, "RiafParams layout");
static_assert(sizeof(RiafParams<double>) == 472, "RiafParams64 layout");
static_assert(sizeof(ExtrasCall<float>) == 216, "ExtrasCall layout");
static_assert(sizeof(ExtrasCall<double>) == 272, "ExtrasCall64 layout");

// The window test of the saturation and frozen-state exits after the
// counters moved: ends the lane (lambda = lambda_max) and flags the exit.
template <class T>
__device__ __forceinline__ void window_exit(const SatParams<T>& S,
                                            int sat_cnt, int frz_cnt, T r,
                                            T lam_max, T& lam,
                                            unsigned int& flags) {
  const bool sat = sat_cnt >= S.window && r <= S.r_max;
  const bool frz = frz_cnt >= S.window;
  if (sat || frz) {
    lam = lam_max;
    flags |= (sat ? 2u : 0u) | (frz ? 4u : 0u);
  }
}

// The ray kernel of family Fam, one thread per ray; an SM must be able
// to hold the functor's kMinBlocks of its blocks at once (see the head of
// this file).
template <class F, class T, int Fam>
__global__ void __launch_bounds__(kThreads, F::kMinBlocks)
LPT_KERNEL(extras_kernel)(ExtrasCall<T> C, Params<T> P, RiafParams<T> R,
                          SatParams<T> S) {
  using K = Tab<T>;
  constexpr int N = 5 + F::kExtras;
  const int n = C.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0;

  if (i < n) {
    const RayStart<T> S0 = initial_state<Fam>(C.alpha[i], C.theta[i], P);
    // The ray's auxiliary constants, read once into registers.
    T aux[F::kAux > 0 ? F::kAux : 1];
#pragma unroll
    for (int k = 0; k < F::kAux; ++k) aux[k] = C.aux[k][i];
    const T p_t = S0.p_t, p_phi = S0.p_phi;
    const T r_capture = P.r_capture;
    const T r_escape = P.r_obs * T(2.0);
    const T lam_max = P.lambda_max;

    T y[N];
#pragma unroll
    for (int c = 0; c < N; ++c) y[c] = c < 5 ? S0.y[c] : T(0.0);
    T k1[N];
    rhs_full<F, Fam>(y, p_t, p_phi, P, R, aux, k1);
    T h = P.h_init;
    T lam = T(0.0);
    int status = S0.bad_obs ? kInvalid : kRunning;
    int sat_cnt = 0, frz_cnt = 0;
    unsigned int flags = 0;
    CycleWatch<T> watch;

    // ---- adaptive DP45 + FSAL loop (ops/kerr_trace.py dp45_integrate),
    // or DOP853 where the source defines LPT_DOP853. A preprocessor
    // switch, not if constexpr: with both pairs in one body nvcc scheduled
    // a DP45 instance otherwise (Movie<8> absorbed 13 % slower, PERF.md
    // §6), and the DP45 instances must stay as they are.
    while (steps < P.max_steps && status == kRunning && lam < lam_max) {
      ++steps;
      const T h_eff = jmax(jmin(h, lam_max - lam), T(0.0));

#ifdef LPT_DOP853
      // DOP853 (kerr_dop853.cuh): k7 is the end stage, yt the event
      // point's scratch
      T yt[N], y5[N], k7[N];
      bool finite_ok;
      const T err_norm = dop853_stages(
          y, k1, h_eff, P.atol, P.rtol,
          [&](const T(&ys)[N], T(&out)[N]) {
            rhs_full<F, Fam>(ys, p_t, p_phi, P, R, aux, out);
          },
          y5, k7, finite_ok);
#else
      T yt[N], k2[N], k3[N], k4[N], k5[N], k6[N], y5[N], k7[N];
#pragma unroll
      for (int c = 0; c < N; ++c) yt[c] = y[c] + h_eff * (K::A21 * k1[c]);
      rhs_full<F, Fam>(yt, p_t, p_phi, P, R, aux, k2);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (K::A31 * k1[c] + K::A32 * k2[c]);
      rhs_full<F, Fam>(yt, p_t, p_phi, P, R, aux, k3);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (K::A41 * k1[c] + K::A42 * k2[c] +
                                K::A43 * k3[c]);
      rhs_full<F, Fam>(yt, p_t, p_phi, P, R, aux, k4);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (K::A51 * k1[c] + K::A52 * k2[c] +
                                K::A53 * k3[c] + K::A54 * k4[c]);
      rhs_full<F, Fam>(yt, p_t, p_phi, P, R, aux, k5);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (K::A61 * k1[c] + K::A62 * k2[c] +
                                K::A63 * k3[c] + K::A64 * k4[c] +
                                K::A65 * k5[c]);
      rhs_full<F, Fam>(yt, p_t, p_phi, P, R, aux, k6);
#pragma unroll
      for (int c = 0; c < N; ++c)
        y5[c] = y[c] + h_eff * (K::B1 * k1[c] + K::B3 * k3[c] +
                                K::B4 * k4[c] + K::B5 * k5[c] +
                                K::B6 * k6[c]);
      rhs_full<F, Fam>(y5, p_t, p_phi, P, R, aux, k7);

      const bool finite_ok = all_finite(y5) && (y5[0] > T(0.0));

      // error scale (increment-aware in float32), norm over N components
      T err_sq = T(0.0);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const T scale = error_scale(y[c], y5[c], k1[c], k7[c], h_eff,
                                    P.atol, P.rtol);
        const T err = h_eff * (K::E1 * k1[c] + K::E3 * k3[c] +
                               K::E4 * k4[c] + K::E5 * k5[c] +
                               K::E6 * k6[c] + K::E7 * k7[c]);
        const T q = finite_ok ? err / scale : T(0.0);
        err_sq = err_sq + q * q;
      }
      const T err_norm = sqrt_(err_sq / static_cast<T>(N));
#endif

      const bool accept = finite_ok && (err_norm <= T(1.0));
      const bool reject = finite_ok && (err_norm > T(1.0));
      const bool blowup = !finite_ok;

      // events on accepted steps (capture has priority; no plunge exit:
      // plunging rays collect emission down to the capture surface)
      const T r_prev = y[0], r_next = y5[0];
      const bool cap = accept && r_prev > r_capture && r_next <= r_capture;
      const bool esc =
          accept && r_prev < r_escape && r_next >= r_escape && !cap;
      const bool event = cap || esc;

      T frac = T(1.0);
      T (&y_acc)[N] = yt;  // the stage scratch is free again
#pragma unroll
      for (int c = 0; c < N; ++c) y_acc[c] = y5[c];
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
        const T h00 = T(2.0) * s3 - T(3.0) * s2 + T(1.0);
        const T h10 = s3 - T(2.0) * s2 + frac;
        const T h01 = -T(2.0) * s3 + T(3.0) * s2;
        const T h11 = s3 - s2;
#pragma unroll
        for (int c = 0; c < N; ++c)
          y_acc[c] = h00 * y[c] + h10 * h_eff * k1[c] + h01 * y5[c] +
                     h11 * h_eff * k7[c];
      }

      // step-size control (one pow serves both shrink and grow; the
      // exponent is -1/(q + 1) for the pair's error order q)
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
        for (int c = 0; c < N; ++c) {
          const bool d = y_acc[c] != y[c];
          changed_any = changed_any || d;
          moved = moved || !same_bits(y_acc[c], y[c]);
          if (c >= 5 && ((S.monitor >> (c - 5)) & 1u))
            changed_mon = changed_mon || d;
        }
        const bool corrupt = !all_finite(y_acc);
        lam = lam + frac * h_eff;
#pragma unroll
        for (int c = 0; c < N; ++c) y[c] = y_acc[c];
        // FSAL: stage 7 seeds the next step's stage 1, except after events.
        if (!event) {
#pragma unroll
          for (int c = 0; c < N; ++c) k1[c] = k7[c];
        }
        if (cap) status = kCaptured;
        else if (esc) status = kEscaped;
        if (corrupt) status = kInvalid;
      }
      if ((reject || blowup) && h_new < P.h_min) status = kInvalid;
      h = h_new;

      // adv: the attempts this iteration stands for. An exact cycle of a
      // frozen lane repeats until the first counter stops it (the step
      // budget, or a window when the exits are on): count them all here,
      // then the window test and the loop's own test end the lane as the
      // attempts themselves would have.
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
    for (int e = 0; e < F::kExtras; ++e)
      C.extras[static_cast<size_t>(e) * n + i] =
          status == kInvalid ? T(0.0) : y[5 + e];
    C.final_alpha[i] = Fin.alpha;
    C.n_half[i] = Fin.n_half;
    C.status[i] = Fin.status;
    C.flags[i] = static_cast<unsigned char>(flags);
    if (C.steps != nullptr) C.steps[i] = steps;
    if (C.census != nullptr) C.census[i] = watch.census();
  }

  // The warp's largest per-ray attempt count (lanes past n count 0).
  const unsigned int warp_max =
      __reduce_max_sync(0xffffffffu, static_cast<unsigned int>(steps));
  if ((threadIdx.x & 31) == 0 && warp_max != 0)
    atomicAdd(C.warp_steps, static_cast<unsigned long long>(warp_max));
}

// What a C entry point does around its switch over the functors: begin()
// zeroes the warp-step counter and forms the kernel's parameter structs
// (false: nothing to launch, *err says whether that is an error);
// launch<F>() starts the kernel for one functor, describe<F>() reports an
// instance's resources. All in the instance's scalar type Real.
struct Prepared {
  Params<Real> P;
  RiafParams<Real> R;
  SatParams<Real> S;
};

inline bool begin(const ExtrasCall<Real>& C, const void* riaf, Prepared* out,
                  cudaError_t* err) {
  if (C.family != kExtrasFamily) {
    *err = cudaErrorInvalidValue;
    return false;
  }
  *err = cudaMemsetAsync(C.warp_steps, 0, sizeof(unsigned long long),
                         static_cast<cudaStream_t>(C.stream));
  if (*err != cudaSuccess || C.n <= 0) return false;
  out->P = Params<Real>{C.M,    C.a,    C.r_plus, C.r_obs, C.theta_obs,
                        C.lambda_max, C.max_steps, C.atol, C.rtol, C.atol,
                        C.rtol, C.h_min, C.tiny_err, C.h_init, C.r_capture,
                        C.q2};
  out->R = *static_cast<const RiafParams<Real>*>(riaf);
  out->S = SatParams<Real>{C.sat_window, C.sat_monitor, C.sat_r_max};
  return true;
}

template <class F>
int launch(const ExtrasCall<Real>& C, const Prepared& K) {
  LPT_KERNEL(extras_kernel)<F, Real, kExtrasFamily>
      <<<(C.n + kThreads - 1) / kThreads, kThreads, 0,
         static_cast<cudaStream_t>(C.stream)>>>(C, K.P, K.R, K.S);
  return static_cast<int>(cudaGetLastError());
}

// An instance's resources on the current card, into out[0..3]: resident
// blocks of kThreads an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers a thread, local memory a thread (bytes: the spills and the
// stack frame) and the block bound it was built with.
template <class F>
int describe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr,
                            LPT_KERNEL(extras_kernel)<F, Real, kExtrasFamily>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, LPT_KERNEL(extras_kernel)<F, Real, kExtrasFamily>, kThreads,
        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = F::kMinBlocks;
  return 0;
}

// A family source names its functors through a picker,
//   struct Pick { template <class Fn> int operator()(int form, int variant,
//                                                     Fn&& fn) const; }
// that calls fn(Tag<F>()) for the functor of (form, variant) and returns
// cudaErrorInvalidValue for any other; its two C entry points are then
// run_entry (launch) and describe_entry (resources).
template <class F>
struct Tag {
  using type = F;
};

template <class Pick>
int run_entry(const void* call, const void* riaf, Pick pick) {
  const ExtrasCall<Real>& C = *static_cast<const ExtrasCall<Real>*>(call);
  Prepared K;
  cudaError_t err;
  if (!begin(C, riaf, &K, &err)) return static_cast<int>(err);
  return pick(C.form, C.variant, [&](auto tag) {
    return launch<typename decltype(tag)::type>(C, K);
  });
}

template <class Pick>
int describe_entry(int form, int variant, int* out, Pick pick) {
  return pick(form, variant, [&](auto tag) {
    return describe<typename decltype(tag)::type>(out);
  });
}

}  // namespace
