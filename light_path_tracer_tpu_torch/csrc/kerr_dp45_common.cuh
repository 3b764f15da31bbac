// Shared device code of the Kerr DP45 kernels (kerr_dp45.cu: shadow and
// disk variants; kerr_dp45_extras.cuh: the extras kernel of the volumetric,
// spectral, Stokes, movie and order transfers; the orbit kernel
// schwarzschild_rk4.cu takes the scalar types and clamps): the tableau, the
// NaN-propagating clamps, Hamilton's equations on the reduced theta-state,
// the Hermite event root, the Bardeen initial conditions, the escape-angle
// extraction of a finished ray and the exact-cycle test of a frozen lane.
// Every function is inlined into its caller.
//
// The metric family is a template argument F of the RHS, the initial
// conditions and the extraction (kKerr, kKerrNewman, kJohannsenPsaltis;
// Kerr by default, which is all the extras kernel instantiates). Each
// family computes what its model in models/ computes: Kerr-Newman is
// Kerr with Q^2 in Delta and W = 2Mr - Q^2 in place of 2Mr;
// Johannsen-Psaltis has its own hand-derived RHS and inverse metric and
// Kerr's Delta and extraction. The Kerr instances compile to the code
// they compiled to before the other families existed.
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
// in separate nvcc processes. It also compiles one embedded pair: the
// DP45 of this header by default, Hairer's DOP853 (kerr_dop853.cuh) when
// it defines LPT_DOP853 (the kerr_dop853*.cu files, each of which includes
// its DP45 sibling; ops/cuda/_build.py links them into a library of their
// own). A source that builds another set of instances of the same kernel
// (the mu chart of the Kerr kernel, *_mu.cu; the Kerr-Newman flow of the
// extras kernel, *_kn.cu) defines LPT_INFIX (_mu, _kn) first. LPT_ENTRY
// names the C entry points of the instance (name, then the infix, then
// _dop853 for the DOP853 pair, then _f64 for double: lpt_kerr_dp45_mu_f64,
// lpt_kerr_dp45_extras_kn_dop853, ...), LPT_KERNEL its kernels
// (kerr_dp45_... or kerr_dop853_...).

#pragma once

#include <cuda_runtime.h>

#ifdef LPT_DOUBLE
typedef double Real;
#else
typedef float Real;
#endif

#ifndef LPT_INFIX
#define LPT_INFIX
#endif
#if defined(LPT_DOP853) && defined(LPT_DOUBLE)
#define LPT_SUFFIX _dop853_f64
#elif defined(LPT_DOP853)
#define LPT_SUFFIX _dop853
#elif defined(LPT_DOUBLE)
#define LPT_SUFFIX _f64
#else
#define LPT_SUFFIX
#endif
#define LPT_CAT_(a, b) a##b
#define LPT_CAT(a, b) LPT_CAT_(a, b)
#define LPT_ENTRY(name) LPT_CAT(LPT_CAT(name, LPT_INFIX), LPT_SUFFIX)

#ifdef LPT_DOP853
#define LPT_KERNEL(name) kerr_dop853_##name
#else
#define LPT_KERNEL(name) kerr_dp45_##name
#endif

#ifdef LPT_EXTERN_POW_F64
// The float64 extras instances raise through lpt_pow_f64.cu's pow, built
// with contraction as PyTorch builds its own: the plain loops' float64
// powers are PyTorch's, and the library pow built under -fmad=false
// rounds 1 ulp otherwise on a few arguments in a million
// (scripts/torch_f64_parity.py). ops/cuda/_build.py defines the macro and
// links the call by relocatable device code.
extern __device__ double lpt_pow_f64(double x, double y);
#endif

namespace {

#ifdef LPT_DOP853
constexpr bool kDop853 = true;
#else
constexpr bool kDop853 = false;
#endif

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
#ifdef LPT_EXTERN_POW_F64
__device__ __forceinline__ double pow_(double x, double y) {
  return ::lpt_pow_f64(x, y);
}
#else
__device__ __forceinline__ double pow_(double x, double y) {
  return pow(x, y);
}
#endif
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

// The metric families (models/kerr.py, kerr_newman.py,
// johannsen_psaltis.py); the values are the wrapper's family codes.
constexpr int kKerr = 0;
constexpr int kKerrNewman = 1;
constexpr int kJohannsenPsaltis = 2;

// q2 (Kerr-Newman's Q^2) and r_pro (its numeric prograde photon-orbit
// radius, for the plunge exit); eps3 and r_freeze (Johannsen-Psaltis's
// deformation and RHS freeze radius). Zero where the family has none.
template <class T>
struct Params {
  T M, a, r_plus, r_obs, theta_obs, lambda_max;
  int max_steps;
  T atol, rtol, atol_ref, rtol_ref, h_min, tiny_err;
  T h_init, r_capture;
  T q2, r_pro, eps3, r_freeze;
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

// The mu chart's floor of its mu component's magnitude in the error scale:
// mu spans [-1, 1] and sits near 0 where theta sits near pi/2, so its
// error is weighed on the theta scale (|d mu| <= |d theta|).
template <class T>
__device__ __forceinline__ T mu_scale_floor(T mag) {
  return jmax(mag, T(1.5707963267948966));
}

// The error scale of one component (ops/kerr_trace.py dp45_integrate):
// in float32 increment-aware, max(|y|, |y5|) + h max(|k1|, |k7|), since
// there the estimator's own roundoff ~eps h max|k| exceeds atol + rtol |y|
// where the derivatives spike (the 1/sin^2-stiff polar axis) and the
// controller would reject forever; float64 keeps the |y|-only scale.
// mu_floor: the mu chart's mu component (mu_scale_floor before the
// increment).
template <class T>
__device__ __forceinline__ T error_scale(T y, T y5, T k1, T k7, T h_eff,
                                         T atol, T rtol,
                                         bool mu_floor = false) {
  T mag = jmax(abs_(y), abs_(y5));
  if (mu_floor) mag = mu_scale_floor(mag);
  if constexpr (kSingle<T>) mag = mag + h_eff * jmax(abs_(k1), abs_(k7));
  return atol + rtol * mag;
}

// Johannsen-Psaltis's contravariant components at (r, theta) with s and c
// the sine and cosine of theta (models/johannsen_psaltis.py _inv_terms):
// the covariant metric, then the exact 2x2 inverse of its (t, phi) block.
template <class T>
struct InverseMetric {
  T tt, tphi, rr, thth, phiphi;
};

template <class T>
__device__ __forceinline__ T safe_det(T D) {
  return abs_(D) < T(1e-30) ? T(1e-30) : D;
}

template <class T>
__device__ __forceinline__ InverseMetric<T> inverse_metric_jp(
    T r, T s, T c, const Params<T>& P) {
  const T M = P.M, a = P.a, eps3 = P.eps3;
  const T sin2 = jmax(s * s, Consts<T>::kSin2Floor);
  const T r2 = r * r;
  const T a2 = a * a;
  const T Sigma = r2 + a2 * c * c;
  const T Delta = r2 - T(2.0) * M * r + a2;
  const T h = eps3 * (M * M * M) * r / (Sigma * Sigma);
  const T two_Mr = T(2.0) * M * r;
  const T g_tt = -(T(1.0) + h) * (T(1.0) - two_Mr / Sigma);
  const T g_tphi = -(a * two_Mr * sin2 / Sigma) * (T(1.0) + h);
  const T g_rr = Sigma * (T(1.0) + h) / (Delta + a2 * h * sin2);
  const T g_phiphi = sin2 * (r2 + a2 + a2 * two_Mr * sin2 / Sigma) +
                     h * a2 * sin2 * (Sigma + two_Mr) / Sigma;
  const T D = safe_det(g_tt * g_phiphi - g_tphi * g_tphi);
  InverseMetric<T> G;
  G.tt = g_phiphi / D;
  G.tphi = -g_tphi / D;
  G.rr = T(1.0) / g_rr;
  G.thth = T(1.0) / Sigma;
  G.phiphi = g_tt / D;
  return G;
}

// Johannsen-Psaltis's hand-derived RHS (models/johannsen_psaltis.py rhs5
// and covariant_derivs_jp, term for term): closed-form r and theta
// partials of the covariant components, pushed through the 2x2 block
// inverse's derivative chain; hard-zeroed inside r <= r_freeze, where r
// is parked at 10 r_freeze + 10. The sin^2 floor's derivative s2p is
// zero where the floor binds.
template <class T>
__device__ __forceinline__ void rhs5_jp(const T y[5], T s, T c, T p_t,
                                        T p_phi, const Params<T>& P,
                                        T out[5]) {
  const T M = P.M, a = P.a, eps3 = P.eps3;
  const T r = y[0], p_r = y[3], p_th = y[4];
  const bool frozen = r <= P.r_freeze;
  const T r_s = frozen ? T(10.0) * P.r_freeze + T(10.0) : r;

  const T s2_raw = s * s;
  const T s2 = jmax(s2_raw, Consts<T>::kSin2Floor);
  const T s2p = s2_raw >= Consts<T>::kSin2Floor ? T(2.0) * s * c : T(0.0);
  const T r2 = r_s * r_s, a2 = a * a;
  const T Sig = r2 + a2 * c * c;
  const T Sig_r = T(2.0) * r_s;
  const T Sig_t = -T(2.0) * a2 * s * c;
  const T Del = r2 - T(2.0) * M * r_s + a2;
  const T Del_r = T(2.0) * r_s - T(2.0) * M;
  const T M3 = M * M * M;
  const T h = eps3 * M3 * r_s / (Sig * Sig);
  const T h_r = eps3 * M3 * (Sig - T(4.0) * r2) / (Sig * Sig * Sig);
  const T h_t = -T(2.0) * eps3 * M3 * r_s * Sig_t / (Sig * Sig * Sig);
  const T W = T(2.0) * M * r_s / Sig;
  const T W_r = T(2.0) * M / Sig - W * Sig_r / Sig;
  const T W_t = -W * Sig_t / Sig;
  const T oh = T(1.0) + h;
  const T g_tt = -oh * (T(1.0) - W);
  const T g_tt_r = -h_r * (T(1.0) - W) + oh * W_r;
  const T g_tt_t = -h_t * (T(1.0) - W) + oh * W_t;
  const T g_tp = -a * W * s2 * oh;
  const T g_tp_r = -a * s2 * (W_r * oh + W * h_r);
  const T g_tp_t = -a * (s2p * W * oh + s2 * (W_t * oh + W * h_t));
  const T B = Del + a2 * h * s2;
  const T B_r = Del_r + a2 * h_r * s2;
  const T B_t = a2 * (h_t * s2 + h * s2p);
  const T g_rr = Sig * oh / B;
  const T g_rr_r = (Sig_r * oh + Sig * h_r) / B - g_rr * B_r / B;
  const T g_rr_t = (Sig_t * oh + Sig * h_t) / B - g_rr * B_t / B;
  const T Pp = r2 + a2 + a2 * W * s2 + a2 * h * (T(1.0) + W);
  const T Pp_r =
      T(2.0) * r_s + a2 * W_r * s2 + a2 * (h_r * (T(1.0) + W) + h * W_r);
  const T Pp_t =
      a2 * (W_t * s2 + W * s2p) + a2 * (h_t * (T(1.0) + W) + h * W_t);
  const T g_pp = s2 * Pp;
  const T g_pp_r = s2 * Pp_r;
  const T g_pp_t = s2p * Pp + s2 * Pp_t;

  const T D = g_tt * g_pp - g_tp * g_tp;
  const T D_r = g_tt_r * g_pp + g_tt * g_pp_r - T(2.0) * g_tp * g_tp_r;
  const T D_t = g_tt_t * g_pp + g_tt * g_pp_t - T(2.0) * g_tp * g_tp_t;
  const T Ds = safe_det(D);
  const T i_tt = g_pp / Ds;
  const T i_tp = -g_tp / Ds;
  const T i_pp = g_tt / Ds;
  const T i_tt_r = (g_pp_r - i_tt * D_r) / Ds;
  const T i_tt_t = (g_pp_t - i_tt * D_t) / Ds;
  const T i_tp_r = (-g_tp_r - i_tp * D_r) / Ds;
  const T i_tp_t = (-g_tp_t - i_tp * D_t) / Ds;
  const T i_pp_r = (g_tt_r - i_pp * D_r) / Ds;
  const T i_pp_t = (g_tt_t - i_pp * D_t) / Ds;
  const T i_rr = T(1.0) / g_rr;
  const T i_rr_r = -g_rr_r * i_rr * i_rr;
  const T i_rr_t = -g_rr_t * i_rr * i_rr;
  const T i_hh = T(1.0) / Sig;
  const T i_hh_r = -Sig_r * i_hh * i_hh;
  const T i_hh_t = -Sig_t * i_hh * i_hh;

  const T dr = i_rr * p_r;
  const T dth = i_hh * p_th;
  const T dphi = i_tp * p_t + i_pp * p_phi;
  const T dHr = T(0.5) * (i_tt_r * p_t * p_t + T(2.0) * i_tp_r * p_t * p_phi +
                          i_rr_r * p_r * p_r + i_hh_r * p_th * p_th +
                          i_pp_r * p_phi * p_phi);
  const T dHt = T(0.5) * (i_tt_t * p_t * p_t + T(2.0) * i_tp_t * p_t * p_phi +
                          i_rr_t * p_r * p_r + i_hh_t * p_th * p_th +
                          i_pp_t * p_phi * p_phi);
  out[0] = frozen ? T(0.0) : dr;
  out[1] = frozen ? T(0.0) : dth;
  out[2] = frozen ? T(0.0) : dphi;
  out[3] = frozen ? T(0.0) : -dHr;
  out[4] = frozen ? T(0.0) : -dHt;
}

// Hamilton's equations on the reduced theta-state (models/kerr.py rhs5),
// hard-zeroed inside r <= 1.001 r_+, with sin_th and cos_th the sine and
// cosine of y[1] (the extras kernel hands them on to its transfer
// function, which needs them too). Kerr-Newman adds Q^2 to Delta and
// takes W = 2Mr - Q^2 for 2Mr in g^tphi and its derivatives (dW/dr =
// 2M); Johannsen-Psaltis runs rhs5_jp.
template <int F = kKerr, class T>
__device__ __forceinline__ void rhs5_trig(const T y[5], T sin_th, T cos_th,
                                          T p_t, T p_phi, const Params<T>& P,
                                          T out[5]) {
  if constexpr (F == kJohannsenPsaltis) {
    rhs5_jp(y, sin_th, cos_th, p_t, p_phi, P, out);
    return;
  }
  constexpr bool kCharged = F == kKerrNewman;
  const T M = P.M, a = P.a;
  const T r = y[0], p_r = y[3], p_th = y[4];
  const bool frozen = r <= P.r_plus * T(1.001);
  const T r_s = frozen ? T(10.0) * P.r_plus + T(10.0) : r;

  const T sin2 = jmax(sin_th * sin_th, Consts<T>::kSin2Floor);
  const T a2 = a * a;
  const T r2 = r_s * r_s;
  const T Sigma = r2 + a2 * cos_th * cos_th;
  T Delta = r2 - T(2.0) * M * r_s + a2;
  if constexpr (kCharged) Delta = Delta + P.q2;
  const T ra2 = r2 + a2;
  const T A = ra2 * ra2 - a2 * Delta * sin2;
  const T W = kCharged ? T(2.0) * M * r_s - P.q2 : T(0.0);

  const T inv_Sigma = T(1.0) / Sigma;
  const T inv_Delta = T(1.0) / Delta;
  const T inv_sin2 = T(1.0) / sin2;
  const T inv_SD = inv_Sigma * inv_Delta;
  const T inv_SD2 = inv_SD * inv_SD;
  const T inv_S2 = inv_Sigma * inv_Sigma;

  const T g_rr = Delta * inv_Sigma;
  const T g_thth = inv_Sigma;
  const T g_tphi =
      kCharged ? -a * W * inv_SD : -T(2.0) * M * a * r_s * inv_SD;
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
  const T dg_tphi_dr =
      kCharged ? -a * (T(2.0) * M * SD - W * dSD_dr) * inv_SD2
               : -(T(2.0) * M * a * (SD - r_s * dSD_dr)) * inv_SD2;
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
      kCharged ? a * W * dSigma_dth * inv_S2 * inv_Delta
               : (T(2.0) * M * a * r_s * dSigma_dth) * inv_S2 * inv_Delta;
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

template <int F, class T>
__device__ __forceinline__ void rhs5(const T y[5], T p_t, T p_phi,
                                     const Params<T>& P, T out[5]) {
  rhs5_trig<F>(y, sin_(y[1]), cos_(y[1]), p_t, p_phi, P, out);
}

// Hamilton's equations on the reduced mu-state (r, mu = cos(theta), phi,
// p_r, p_mu) of Kerr and Kerr-Newman (models/kerr.py rhs5_mu, term for
// term): the same Hamiltonian after the canonical point transformation,
// with s = sin^2 = (1 - mu)(1 + mu) floored at 1e-15, so every component
// is a rational function of (r, mu) and no sin or cos is called.
// Hard-zeroed inside r <= 1.001 r_+ like rhs5_trig.
template <int F, class T>
__device__ __forceinline__ void rhs5_mu(const T y[5], T p_t, T p_phi,
                                        const Params<T>& P, T out[5]) {
  static_assert(F == kKerr || F == kKerrNewman,
                "the mu chart has Kerr's and Kerr-Newman's RHS only");
  constexpr bool kCharged = F == kKerrNewman;
  const T M = P.M, a = P.a;
  const T r = y[0], mu = y[1], p_r = y[3], p_mu = y[4];
  const bool frozen = r <= P.r_plus * T(1.001);
  const T r_s = frozen ? T(10.0) * P.r_plus + T(10.0) : r;

  const T a2 = a * a;
  const T r2 = r_s * r_s;
  const T s = jmax((T(1.0) - mu) * (T(1.0) + mu), Consts<T>::kSin2Floor);
  const T Sigma = r2 + a2 * mu * mu;
  T Delta = r2 - T(2.0) * M * r_s + a2;
  if constexpr (kCharged) Delta = Delta + P.q2;
  const T ra2 = r2 + a2;
  const T A = ra2 * ra2 - a2 * Delta * s;
  const T W = kCharged ? T(2.0) * M * r_s - P.q2 : T(0.0);

  const T inv_Sigma = T(1.0) / Sigma;
  const T inv_Delta = T(1.0) / Delta;
  const T inv_s = T(1.0) / s;
  const T inv_SD = inv_Sigma * inv_Delta;
  const T inv_SD2 = inv_SD * inv_SD;
  const T inv_S2 = inv_Sigma * inv_Sigma;

  const T g_rr = Delta * inv_Sigma;
  const T g_mumu = s * inv_Sigma;
  const T g_tphi =
      kCharged ? -a * W * inv_SD : -T(2.0) * M * a * r_s * inv_SD;
  const T g_phiphi = (Delta - a2 * s) * inv_SD * inv_s;

  const T dr = g_rr * p_r;
  const T dmu = g_mumu * p_mu;
  const T dphi = g_tphi * p_t + g_phiphi * p_phi;

  // radial derivatives (s does not depend on r)
  const T SD = Sigma * Delta;
  const T dSigma_dr = T(2.0) * r_s;
  const T dDelta_dr = T(2.0) * r_s - T(2.0) * M;
  const T dA_dr = T(4.0) * r_s * ra2 - a2 * dDelta_dr * s;
  const T dSD_dr = dSigma_dr * Delta + Sigma * dDelta_dr;

  const T dg_tt_dr = -(dA_dr * SD - A * dSD_dr) * inv_SD2;
  const T dg_tphi_dr =
      kCharged ? -a * (T(2.0) * M * SD - W * dSD_dr) * inv_SD2
               : -(T(2.0) * M * a * (SD - r_s * dSD_dr)) * inv_SD2;
  const T dg_rr_dr = (dDelta_dr * Sigma - Delta * dSigma_dr) * inv_S2;
  const T dg_mumu_dr = -s * dSigma_dr * inv_S2;
  const T inv_den_phi = inv_SD * inv_s;
  const T inv_den_phi2 = inv_den_phi * inv_den_phi;
  const T den_phi = SD * s;
  const T num = Delta - a2 * s;
  const T dg_phiphi_dr =
      (dDelta_dr * den_phi - num * dSD_dr * s) * inv_den_phi2;

  const T dp_r =
      -T(0.5) * (dg_tt_dr * p_t * p_t + T(2.0) * dg_tphi_dr * p_t * p_phi +
                 dg_rr_dr * p_r * p_r + dg_mumu_dr * p_mu * p_mu +
                 dg_phiphi_dr * p_phi * p_phi);

  // polar (mu) derivatives, all polynomial in mu
  const T ds_dmu = -T(2.0) * mu;
  const T dSigma_dmu = T(2.0) * a2 * mu;
  const T dA_dmu = T(2.0) * a2 * Delta * mu;
  const T dSD_dmu = dSigma_dmu * Delta;

  const T dg_tt_dmu = -(dA_dmu * SD - A * dSD_dmu) * inv_SD2;
  const T dg_tphi_dmu = kCharged
                            ? a * W * dSD_dmu * inv_SD2
                            : T(2.0) * M * a * r_s * dSD_dmu * inv_SD2;
  const T dg_rr_dmu = -Delta * dSigma_dmu * inv_S2;
  const T dg_mumu_dmu = (ds_dmu * Sigma - s * dSigma_dmu) * inv_S2;
  const T dnum_dmu = T(2.0) * a2 * mu;
  const T dden_dmu = dSD_dmu * s + SD * ds_dmu;
  const T dg_phiphi_dmu =
      (dnum_dmu * den_phi - num * dden_dmu) * inv_den_phi2;

  const T dp_mu =
      -T(0.5) * (dg_tt_dmu * p_t * p_t + T(2.0) * dg_tphi_dmu * p_t * p_phi +
                 dg_rr_dmu * p_r * p_r + dg_mumu_dmu * p_mu * p_mu +
                 dg_phiphi_dmu * p_phi * p_phi);

  out[0] = frozen ? T(0.0) : dr;
  out[1] = frozen ? T(0.0) : dmu;
  out[2] = frozen ? T(0.0) : dphi;
  out[3] = frozen ? T(0.0) : dp_r;
  out[4] = frozen ? T(0.0) : dp_mu;
}

// The RHS of a chart: rhs5 (theta) or rhs5_mu (kMu).
template <int F, bool kMu, class T>
__device__ __forceinline__ void rhs5_chart(const T y[5], T p_t, T p_phi,
                                           const Params<T>& P, T out[5]) {
  if constexpr (kMu) rhs5_mu<F>(y, p_t, p_phi, P, out);
  else rhs5<F>(y, p_t, p_phi, P, out);
}

// The canonical point transformations of models/kerr.py: state_to_mu,
// (r, theta, phi, p_r, p_theta) -> (r, mu, phi, p_r, p_mu) with
// p_mu = -p_theta / max(sin(theta), sqrt(1e-15)), and state_from_mu, back
// with theta = acos(clip(mu)) and sin(theta) from (1 - mu)(1 + mu), in
// place.
template <class T>
__device__ __forceinline__ void state_to_mu(T y[5]) {
  const T sin_th = sin_(y[1]);
  const T mu = cos_(y[1]);
  const T sin_safe = jmax(sin_th, T(3.1622776601683794e-08));
  y[1] = mu;
  y[4] = -y[4] / sin_safe;
}

template <class T>
__device__ __forceinline__ void state_from_mu(T y[5]) {
  const T mu_c = jclip(y[1], -T(1.0), T(1.0));
  const T sin_th =
      sqrt_(jmax((T(1.0) - mu_c) * (T(1.0) + mu_c), Consts<T>::kSin2Floor));
  y[1] = acos_(mu_c);
  y[4] = -sin_th * y[4];
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
// shadow variant's plunge radius reuses. Delta is the family's (Kerr's
// for Johannsen-Psaltis), the null normalisation of p_r takes the
// family's inverse metric.
template <class T>
struct RayStart {
  T y[5];
  T p_t, p_phi;
  bool bad_obs;
  T sin_al, sin_scr, cos_scr, cos_th, Sigma, Delta;
};

// Bardeen initial conditions for screen angle al and azimuth scr.
template <int F = kKerr, class T>
__device__ __forceinline__ RayStart<T> initial_state(T al, T scr,
                                                     const Params<T>& P) {
  constexpr bool kCharged = F == kKerrNewman;
  const T M = P.M, a = P.a;
  RayStart<T> S;
  const T r = P.r_obs, th = P.theta_obs;
  const T sin_th = sin_(th), cos_th = cos_(th);
  const T sin2 = jmax(sin_th * sin_th, Consts<T>::kSin2Floor);
  const T Sigma = r * r + a * a * cos_th * cos_th;
  T Delta = r * r - T(2.0) * M * r + a * a;
  if constexpr (kCharged) Delta = Delta + P.q2;
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
  InverseMetric<T> G;
  if constexpr (F == kJohannsenPsaltis) {
    G = inverse_metric_jp(r, sin_th, cos_th, P);
  } else {
    const T r2 = r * r, a2 = a * a;
    const T Sg = r2 + a2 * cos_th * cos_th;
    T Dl = r2 - T(2.0) * M * r + a2;
    if constexpr (kCharged) Dl = Dl + P.q2;
    const T ra2 = r2 + a2;
    const T A = ra2 * ra2 - a2 * Dl * sin2;
    const T SD = Sg * Dl;
    G.tt = -A / SD;
    G.tphi = kCharged ? -a * (T(2.0) * M * r - P.q2) / SD
                      : -T(2.0) * M * a * r / SD;
    G.rr = Dl / Sg;
    G.thth = T(1.0) / Sg;
    G.phiphi = (Dl - a2 * sin2) / (SD * sin2);
  }
  const T g_tt = G.tt, g_tphi = G.tphi, g_rr = G.rr, g_thth = G.thth,
          g_phiphi = G.phiphi;
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
// captured. Kerr-Newman's Delta and W carry its charge; Johannsen-Psaltis
// extracts as Kerr. Shared by the shadow and disk kernel (kerr_dp45.cu)
// and the extras kernel (kerr_dp45_extras.cuh).
template <class T>
struct Final {
  T alpha;
  int n_half, status;
};

template <int F = kKerr, class T>
__device__ __forceinline__ Final<T> finalize(const T* y, T p_t, T p_phi,
                                             int status_f, T r_reclass,
                                             const Params<T>& P) {
  constexpr bool kCharged = F == kKerrNewman;
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
  T Delta_f = r_s * r_s - T(2.0) * M * r_s + a * a;
  if constexpr (kCharged) Delta_f = Delta_f + P.q2;
  const bool degenerate =
      Sigma_f <= T(1e-15) || abs_(Delta_f) <= T(1e-15);
  const T S = degenerate ? T(1.0) : Sigma_f;
  const T D = degenerate ? T(1.0) : Delta_f;

  const T dr_dl = D / S * y[3];
  const T dth_dl = y[4] / S;
  const T two_M_r =
      kCharged ? T(2.0) * M * r_s - P.q2 : T(2.0) * M * r_s;
  const T dphi_dl = -a * two_M_r / (S * D) * p_t +
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
  Final<T> out;
  out.status = invalid_f ? kInvalid : (cap_f ? kCaptured : kEscaped);
  out.alpha = (out.status == kEscaped && !tiny_v) ? alpha : quiet_nan<T>();
  out.n_half = (invalid_f && status_f == kInvalid) ? 0 : n_half;
  return out;
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
