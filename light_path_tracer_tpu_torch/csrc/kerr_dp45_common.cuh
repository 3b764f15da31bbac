// Shared device code of the Kerr DP45 kernels (kerr_dp45.cu: shadow and
// disk variants; kerr_dp45_extras.cuh: the extras kernel of the volumetric,
// spectral, Stokes, movie and order transfers; the orbit kernel
// schwarzschild_rk4.cu takes the scalar types and clamps): the tableau, the
// NaN-propagating clamps, Hamilton's equations on the reduced theta-state,
// the Hermite event root, the Bardeen initial conditions, the escape-angle
// extraction of a finished ray and the exact-cycle test of a frozen lane.
// Every function is inlined into its caller.
//
// Everything is templated on the scalar type T, float or double, as the
// plain loop (ops/kerr_trace.py) runs in its tensors' dtype. Numerics
// follow the JAX package's dp45_integrate in that dtype: the tableau is
// the double coefficients (rounded once to float in the float instance),
// stage sums are taken as c0 k0 + c1 k1 + ... and then multiplied by h,
// and the max/min/clip helpers propagate NaN as jnp.maximum/minimum/clip
// do. Every literal is written T(x): each one rounds from double to float
// exactly as the float literal x-with-f did (no literal of these sources
// sits where the two roundings differ). The float instance calls sinf,
// cosf, powf, ... and the double one sin, cos, pow, ... through the
// overloads below. Every source builds with -fmad=false
// (ops/cuda/_build.py): nvcc contracts no a*b + c into an FMA, so each
// product and each sum rounds apart as in the plain loop and in XLA on
// the CPU. With contraction, ray (959, 511) of the config-4 grid froze
// on the card where the reference escapes in 51 attempts.
//
// A source file compiles one scalar type: float by default, double when
// it defines LPT_DOUBLE before including this header (the *_f64.cu files,
// each of which includes its float sibling), so the two instances build
// in separate nvcc processes. LPT_ENTRY names the C entry points of the
// instance (name, or name_f64).

#pragma once

#include <cuda_runtime.h>

#ifdef LPT_DOUBLE
typedef double Real;
#define LPT_ENTRY(name) name##_f64
#else
typedef float Real;
#define LPT_ENTRY(name) name
#endif

namespace {

constexpr int kThreads = 128;
constexpr unsigned int kFullMask = 0xffffffffu;

constexpr int kRunning = 2;
constexpr int kEscaped = 1;
constexpr int kCaptured = -1;
constexpr int kInvalid = 0;

template <class T> constexpr bool kSingle = false;
template <> constexpr bool kSingle<float> = true;

// The math library in T: sinf, cosf, ... for float, sin, cos, ... for
// double.
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float pow_(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float acos_(float x) { return acosf(x); }
__device__ __forceinline__ double acos_(double x) { return acos(x); }
__device__ __forceinline__ float atan2_(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double atan2_(double y, double x) {
  return atan2(y, x);
}

// Bitwise equality (NaN payloads and signed zeros told apart).
__device__ __forceinline__ bool same_bits(float x, float y) {
  return __float_as_int(x) == __float_as_int(y);
}
__device__ __forceinline__ bool same_bits(double x, double y) {
  return __double_as_longlong(x) == __double_as_longlong(y);
}

template <class T>
__device__ __forceinline__ T quiet_nan() {
  if constexpr (kSingle<T>) return __int_as_float(0x7fc00000);
  else return __longlong_as_double(0x7ff8000000000000LL);
}

// kMax: the largest finite value of T.
template <class T> struct Consts;
template <> struct Consts<float> {
  static constexpr float kSin2Floor = 1e-15f;
  static constexpr float kPi = (float)3.14159265358979323846;
  static constexpr float kMax = 3.402823466e+38f;
};
template <> struct Consts<double> {
  static constexpr double kSin2Floor = 1e-15;
  static constexpr double kPi = 3.14159265358979323846;
  static constexpr double kMax = 1.7976931348623157e308;
};

// Dormand-Prince 4(5) tableau (ops/tableau.py): the double values, rounded
// once in the float instance.
template <class T>
struct Tab {
  static constexpr T A21 = T(1.0 / 5.0);
  static constexpr T A31 = T(3.0 / 40.0), A32 = T(9.0 / 40.0);
  static constexpr T A41 = T(44.0 / 45.0), A42 = T(-56.0 / 15.0),
                     A43 = T(32.0 / 9.0);
  static constexpr T A51 = T(19372.0 / 6561.0), A52 = T(-25360.0 / 2187.0),
                     A53 = T(64448.0 / 6561.0), A54 = T(-212.0 / 729.0);
  static constexpr T A61 = T(9017.0 / 3168.0), A62 = T(-355.0 / 33.0),
                     A63 = T(46732.0 / 5247.0), A64 = T(49.0 / 176.0),
                     A65 = T(-5103.0 / 18656.0);
  static constexpr T B1 = T(35.0 / 384.0), B3 = T(500.0 / 1113.0),
                     B4 = T(125.0 / 192.0), B5 = T(-2187.0 / 6784.0),
                     B6 = T(11.0 / 84.0);
  static constexpr T E1 = T(71.0 / 57600.0), E3 = T(-71.0 / 16695.0),
                     E4 = T(71.0 / 1920.0), E5 = T(-17253.0 / 339200.0),
                     E6 = T(22.0 / 525.0), E7 = T(-1.0 / 40.0);
};

template <class T>
struct Params {
  T M, a, r_plus, r_obs, theta_obs, lambda_max;
  int max_steps;
  T atol, rtol, atol_ref, rtol_ref, h_min, tiny_err;
  T h_init, r_capture;
};

// NaN-propagating max/min/clip (jnp.maximum / jnp.minimum / jnp.clip).
template <class T>
__device__ __forceinline__ T jmax(T x, T y) {
  return (x > y || x != x) ? x : y;
}
template <class T>
__device__ __forceinline__ T jmin(T x, T y) {
  return (x < y || x != x) ? x : y;
}
template <class T>
__device__ __forceinline__ T jclip(T x, T lo, T hi) {
  return jmin(jmax(x, lo), hi);
}

// False for NaN and +-inf (the comparison is false for NaN).
template <class T>
__device__ __forceinline__ bool is_finite_f(T x) {
  return abs_(x) <= Consts<T>::kMax;
}

template <class T, int N>
__device__ __forceinline__ bool all_finite(const T (&y)[N]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) ok = ok && is_finite_f(y[i]);
  return ok;
}

// The error scale of one component (ops/kerr_trace.py dp45_integrate):
// in float32 increment-aware, max(|y|, |y5|) + h max(|k1|, |k7|), since
// there the estimator's own roundoff ~eps h max|k| exceeds atol + rtol |y|
// where the derivatives spike (the 1/sin^2-stiff polar axis) and the
// controller would reject forever; float64 keeps the |y|-only scale.
template <class T>
__device__ __forceinline__ T error_scale(T y, T y5, T k1, T k7, T h_eff,
                                         T atol, T rtol) {
  T mag = jmax(abs_(y), abs_(y5));
  if constexpr (kSingle<T>) mag = mag + h_eff * jmax(abs_(k1), abs_(k7));
  return atol + rtol * mag;
}

// Hamilton's equations on the reduced theta-state (models/kerr.py rhs5),
// hard-zeroed inside r <= 1.001 r_+, with sin_th and cos_th the sine and
// cosine of y[1] (the extras kernel hands them on to its transfer
// function, which needs them too).
template <class T>
__device__ __forceinline__ void rhs5_trig(const T y[5], T sin_th, T cos_th,
                                          T p_t, T p_phi, const Params<T>& P,
                                          T out[5]) {
  const T M = P.M, a = P.a;
  const T r = y[0], p_r = y[3], p_th = y[4];
  const bool frozen = r <= P.r_plus * T(1.001);
  const T r_s = frozen ? T(10.0) * P.r_plus + T(10.0) : r;

  const T sin2 = jmax(sin_th * sin_th, Consts<T>::kSin2Floor);
  const T a2 = a * a;
  const T r2 = r_s * r_s;
  const T Sigma = r2 + a2 * cos_th * cos_th;
  const T Delta = r2 - T(2.0) * M * r_s + a2;
  const T ra2 = r2 + a2;
  const T A = ra2 * ra2 - a2 * Delta * sin2;

  const T inv_Sigma = T(1.0) / Sigma;
  const T inv_Delta = T(1.0) / Delta;
  const T inv_sin2 = T(1.0) / sin2;
  const T inv_SD = inv_Sigma * inv_Delta;
  const T inv_SD2 = inv_SD * inv_SD;
  const T inv_S2 = inv_Sigma * inv_Sigma;

  const T g_rr = Delta * inv_Sigma;
  const T g_thth = inv_Sigma;
  const T g_tphi = -T(2.0) * M * a * r_s * inv_SD;
  const T g_phiphi = (Delta - a2 * sin2) * inv_SD * inv_sin2;

  const T dr = g_rr * p_r;
  const T dth = g_thth * p_th;
  const T dphi = g_tphi * p_t + g_phiphi * p_phi;

  // radial derivatives of the inverse metric
  const T SD = Sigma * Delta;
  const T dSigma_dr = T(2.0) * r_s;
  const T dDelta_dr = T(2.0) * r_s - T(2.0) * M;
  const T dA_dr = T(4.0) * r_s * ra2 - a2 * dDelta_dr * sin2;
  const T dSD_dr = dSigma_dr * Delta + Sigma * dDelta_dr;

  const T dg_tt_dr = -(dA_dr * SD - A * dSD_dr) * inv_SD2;
  const T dg_tphi_dr = -(T(2.0) * M * a * (SD - r_s * dSD_dr)) * inv_SD2;
  const T dg_rr_dr = (dDelta_dr * Sigma - Delta * dSigma_dr) * inv_S2;
  const T dg_thth_dr = -dSigma_dr * inv_S2;
  const T inv_den_phi = inv_SD * inv_sin2;
  const T inv_den_phi2 = inv_den_phi * inv_den_phi;
  const T den_phi = SD * sin2;
  const T dg_phiphi_dr =
      (dDelta_dr * den_phi - (Delta - a2 * sin2) * dSD_dr * sin2) *
      inv_den_phi2;

  const T dp_r =
      -T(0.5) * (dg_tt_dr * p_t * p_t + T(2.0) * dg_tphi_dr * p_t * p_phi +
                 dg_rr_dr * p_r * p_r + dg_thth_dr * p_th * p_th +
                 dg_phiphi_dr * p_phi * p_phi);

  // polar derivatives of the inverse metric
  const T sc = sin_th * cos_th;
  const T dSigma_dth = -T(2.0) * a2 * sc;
  const T dA_dth = -T(2.0) * a2 * Delta * sc;

  const T dg_tt_dth = -(dA_dth * SD - A * dSigma_dth * Delta) * inv_SD2;
  const T dg_tphi_dth =
      (T(2.0) * M * a * r_s * dSigma_dth) * inv_S2 * inv_Delta;
  const T dg_rr_dth = -Delta * dSigma_dth * inv_S2;
  const T dg_thth_dth = -dSigma_dth * inv_S2;

  const T num = Delta - a2 * sin2;
  const T dnum_dth = -T(2.0) * a2 * sc;
  const T dden_dth = dSigma_dth * Delta * sin2 + T(2.0) * SD * sc;
  const T dg_phiphi_dth = (dnum_dth * den_phi - num * dden_dth) *
                          inv_den_phi2;

  const T dp_th =
      -T(0.5) * (dg_tt_dth * p_t * p_t + T(2.0) * dg_tphi_dth * p_t * p_phi +
                 dg_rr_dth * p_r * p_r + dg_thth_dth * p_th * p_th +
                 dg_phiphi_dth * p_phi * p_phi);

  out[0] = frozen ? T(0.0) : dr;
  out[1] = frozen ? T(0.0) : dth;
  out[2] = frozen ? T(0.0) : dphi;
  out[3] = frozen ? T(0.0) : dp_r;
  out[4] = frozen ? T(0.0) : dp_th;
}

template <class T>
__device__ __forceinline__ void rhs5(const T y[5], T p_t, T p_phi,
                                     const Params<T>& P, T out[5]) {
  rhs5_trig(y, sin_(y[1]), cos_(y[1]), p_t, p_phi, P, out);
}

// Step fraction where the cubic Hermite interpolant of r crosses target:
// four clamped Newton iterations from the linear estimate, which is kept
// when the result is not finite.
template <class T>
__device__ __forceinline__ T hermite_crossing_frac(T r0, T r1, T fr0, T fr1,
                                                   T h, T target,
                                                   T frac_linear) {
  T s = frac_linear;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const T s2 = s * s;
    const T p = (T(2.0) * s2 * s - T(3.0) * s2 + T(1.0)) * r0 +
                (s2 * s - T(2.0) * s2 + s) * h * fr0 +
                (-T(2.0) * s2 * s + T(3.0) * s2) * r1 +
                (s2 * s - s2) * h * fr1;
    const T dp = (T(6.0) * s2 - T(6.0) * s) * r0 +
                 (T(3.0) * s2 - T(4.0) * s + T(1.0)) * h * fr0 +
                 (-T(6.0) * s2 + T(6.0) * s) * r1 +
                 (T(3.0) * s2 - T(2.0) * s) * h * fr1;
    const bool ok = abs_(dp) > T(1e-30);
    const T step = ok ? (p - target) / dp : T(0.0);
    s = jclip(s - step, T(0.0), T(1.0));
  }
  return is_finite_f(s) ? s : frac_linear;
}

// A ray's start at the observer (models/kerr.py initial_conditions_5d):
// the reduced state, the conserved momenta, and the observer terms the
// shadow variant's plunge radius reuses.
template <class T>
struct RayStart {
  T y[5];
  T p_t, p_phi;
  bool bad_obs;
  T sin_al, sin_scr, cos_scr, cos_th, Sigma, Delta;
};

// Bardeen initial conditions for screen angle al and azimuth scr.
template <class T>
__device__ __forceinline__ RayStart<T> initial_state(T al, T scr,
                                                     const Params<T>& P) {
  const T M = P.M, a = P.a;
  RayStart<T> S;
  const T r = P.r_obs, th = P.theta_obs;
  const T sin_th = sin_(th), cos_th = cos_(th);
  const T sin2 = jmax(sin_th * sin_th, Consts<T>::kSin2Floor);
  const T Sigma = r * r + a * a * cos_th * cos_th;
  const T Delta = r * r - T(2.0) * M * r + a * a;
  const bool bad_obs = (Delta <= T(0.0)) || (Sigma <= T(0.0));

  const T E = T(1.0);
  const T sin_al = sin_(al);
  const T rho = r * sin_al * sqrt_(Sigma) / sqrt_(bad_obs ? T(1.0) : Delta);
  const T sin_scr = sin_(scr), cos_scr = cos_(scr);
  const T alpha_s = -rho * sin_scr;
  const T beta_s = -rho * cos_scr;
  const T xi = -alpha_s * sin_th;
  const T eta =
      beta_s * beta_s + cos_th * cos_th * (alpha_s * alpha_s - a * a);
  const T L = xi * E;
  const T Q = eta * E * E;
  const T p_t = -E;
  const T p_phi = L;
  const T Theta =
      jmax(Q - cos_th * cos_th * (L * L / sin2 - a * a * E * E), T(0.0));
  const T p_th0 = (cos_scr > T(0.0) ? -T(1.0) : T(1.0)) * sqrt_(Theta);

  // inverse metric at the observer
  const T r2 = r * r, a2 = a * a;
  const T Sg = r2 + a2 * cos_th * cos_th;
  const T Dl = r2 - T(2.0) * M * r + a2;
  const T ra2 = r2 + a2;
  const T A = ra2 * ra2 - a2 * Dl * sin2;
  const T SD = Sg * Dl;
  const T g_tt = -A / SD;
  const T g_tphi = -T(2.0) * M * a * r / SD;
  const T g_rr = Dl / Sg;
  const T g_thth = T(1.0) / Sg;
  const T g_phiphi = (Dl - a2 * sin2) / (SD * sin2);
  const T other = g_tt * p_t * p_t + T(2.0) * g_tphi * p_t * p_phi +
                  g_thth * p_th0 * p_th0 + g_phiphi * p_phi * p_phi;
  const T p_r_sq = -other / g_rr;
  const T p_r0 =
      (cos_(al) >= T(0.0) ? -T(1.0) : T(1.0)) * sqrt_(jmax(p_r_sq, T(0.0)));

  S.y[0] = r;
  S.y[1] = th;
  S.y[2] = T(0.0);
  S.y[3] = p_r0;
  S.y[4] = p_th0;
  S.p_t = p_t;
  S.p_phi = p_phi;
  S.bad_obs = bad_obs;
  S.sin_al = sin_al;
  S.sin_scr = sin_scr;
  S.cos_scr = cos_scr;
  S.cos_th = cos_th;
  S.Sigma = Sigma;
  S.Delta = Delta;
  return S;
}

// Escape heading, half-orbit count and status fold of a finished ray
// (models/kerr.py extract_angle, then ops/kerr_trace.py finalize_angles),
// term by term in the same order, with M and a as values of T as the
// torch version has them: status_f is the integration's raw status, and a
// ray at or inside r_reclass (1.1 x the capture radius) counts as
// captured. Shared by the shadow and disk kernel (kerr_dp45.cu) and the
// extras kernel (kerr_dp45_extras.cuh).
template <class T>
struct Final {
  T alpha;
  int n_half, status;
};

template <class T>
__device__ __forceinline__ Final<T> finalize(const T* y, T p_t, T p_phi,
                                             int status_f, T r_reclass,
                                             const Params<T>& P) {
  const T M = P.M, a = P.a;
  const T r_f = y[0], th_f = y[1], phi_f = y[2];
  int n_half = static_cast<int>(floor_(abs_(phi_f) / Consts<T>::kPi));
  const bool is_captured = status_f == kCaptured || r_f <= r_reclass;
  const bool bad_state =
      !(is_finite_f(r_f) && is_finite_f(th_f) && is_finite_f(phi_f));

  const T sin_th = sin_(th_f), cos_th = cos_(th_f);
  const T sin2 = jmax(sin_th * sin_th, Consts<T>::kSin2Floor);
  const T r_s = (bad_state || is_captured) ? T(10.0) * M + T(10.0) : r_f;
  const T Sigma_f = r_s * r_s + a * a * cos_th * cos_th;
  const T Delta_f = r_s * r_s - T(2.0) * M * r_s + a * a;
  const bool degenerate =
      Sigma_f <= T(1e-15) || abs_(Delta_f) <= T(1e-15);
  const T S = degenerate ? T(1.0) : Sigma_f;
  const T D = degenerate ? T(1.0) : Delta_f;

  const T dr_dl = D / S * y[3];
  const T dth_dl = y[4] / S;
  const T dphi_dl = -a * (T(2.0) * M * r_s) / (S * D) * p_t +
                    (D - a * a * sin2) / (S * D * sin2) * p_phi;
  const T sin_phi = sin_(phi_f), cos_phi = cos_(phi_f);
  const T vx = sin_th * cos_phi * dr_dl + r_s * cos_th * cos_phi * dth_dl -
               r_s * sin_th * sin_phi * dphi_dl;
  const T vy = sin_th * sin_phi * dr_dl + r_s * cos_th * sin_phi * dth_dl +
               r_s * sin_th * cos_phi * dphi_dl;
  const T vz = cos_th * dr_dl - r_s * sin_th * dth_dl;
  const bool bad_v = !(is_finite_f(vx) && is_finite_f(vy) && is_finite_f(vz));
  const T v_mag = sqrt_(vx * vx + vy * vy + vz * vz);
  const bool tiny_v = v_mag < T(1e-30);
  const T v_safe = tiny_v ? T(1.0) : v_mag;
  const T alpha = acos_(jclip(-vx / v_safe, -T(1.0), T(1.0)));
  const bool invalid = bad_state || degenerate || bad_v;
  const int ext_status = is_captured ? -1 : (invalid ? 0 : 1);
  if (bad_state && !is_captured) n_half = 0;

  const bool invalid_f = status_f == kInvalid || ext_status == 0;
  const bool cap_f = !invalid_f && ext_status == -1;
  Final<T> F;
  F.status = invalid_f ? kInvalid : (cap_f ? kCaptured : kEscaped);
  F.alpha = (F.status == kEscaped && !tiny_v) ? alpha : quiet_nan<T>();
  F.n_half = (invalid_f && status_f == kInvalid) ? 0 : n_half;
  return F;
}

// The exact-cycle test of a frozen lane. An attempt is a pure function of
// the lane's registers (y, k1, h, lam) and the ray's constants. Once an
// accepted step has seeded k1 from stage 7 (FSAL), k1 = rhs(y) for the
// current y: a rejected attempt leaves y and k1 alone, and an accepted one
// whose state comes back bitwise unchanged sets k1 = rhs(y5) = rhs(y)
// again. So while y stays bitwise frozen, the next attempt depends on
// (h, lam) alone, and lam only through h_eff = min(h, lam_max - lam). When
// (h, lam) returns bitwise to an earlier value of the same frozen streak,
// the lane repeats that stretch of attempts forever: y, k1, lam and the
// status never change again, and the lane stops only where a counter
// stops it (the step budget, the saturation and frozen-state windows).
// The kernels then count those attempts at once instead of making them,
// which gives bitwise the outputs the attempts would have given.
//
// The streak holds one snapshot of (h, lam), taken Brent-style at streak
// lengths 1, 2, 4, 8, ..., so a cycle of period P is seen within about 2P
// attempts of its start. If lam grows along the streak, no pair repeats
// and the lane runs on as before.
template <class T>
struct CycleWatch {
  int streak = 0;       // attempts in a row that left y bitwise unchanged
  int period = 0;       // the first cycle's period (0: none seen)
  bool settled = false; // k1 came from stage 7 of an accepted step
  bool lam_moved = false;
  T h_s = T(0.0), lam_s = T(0.0);

  // Book one attempt. still: it left y bitwise unchanged (and recorded
  // nothing); accepted_fsal: it was an accepted step that seeded k1 from
  // stage 7; h and lam: the registers after it; running: the lane goes on
  // (still RUNNING with lambda budget left). Returns true when (h, lam)
  // closes a cycle of a lane that goes on.
  __device__ __forceinline__ bool update(bool still, bool accepted_fsal,
                                         T h, T lam, bool running) {
    const bool was_settled = settled;
    settled = settled || accepted_fsal;
    if (!still || !was_settled) {
      streak = 0;
      lam_moved = false;
      return false;
    }
    ++streak;
    bool closed = false;
    if (streak > 1) {
      lam_moved = lam_moved || !same_bits(lam, lam_s);
      closed = running && same_bits(h, h_s) && same_bits(lam, lam_s);
      if (closed && period == 0)
        period = streak - (1 << (31 - __clz(streak - 1)));
    }
    if ((streak & (streak - 1)) == 0) {
      h_s = h;
      lam_s = lam;
    }
    return closed;
  }

  // The census word of the kernels' probe: the final frozen streak
  // (20 bits, saturating), whether lam moved along it (bit 20) and the
  // first cycle's period (bits 21-30, saturating).
  __device__ __forceinline__ int census() const {
    const int s = streak < 0xFFFFF ? streak : 0xFFFFF;
    const int p = period < 1023 ? period : 1023;
    return s | (lam_moved ? 1 << 20 : 0) | (p << 21);
  }
};

}  // namespace
