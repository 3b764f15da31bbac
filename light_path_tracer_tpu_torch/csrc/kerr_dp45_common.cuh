// Shared device code of the Kerr DP45 kernels (kerr_dp45.cu: shadow and
// disk variants; kerr_dp45_extras.cuh: the extras kernel of the volumetric,
// spectral, Stokes, movie and order transfers): the tableau, the
// NaN-propagating clamps, Hamilton's equations on the reduced theta-state,
// the Hermite event root and the Bardeen initial conditions. Every function
// is inlined into its caller.
//
// Numerics follow the float32 path of the JAX package's dp45_integrate:
// the tableau is the double coefficients rounded to float, stage sums are
// taken as c0 k0 + c1 k1 + ... and then multiplied by h, and the max/min/
// clip helpers propagate NaN as jnp.maximum/minimum/clip do.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

constexpr int kRunning = 2;
constexpr int kEscaped = 1;
constexpr int kCaptured = -1;
constexpr int kInvalid = 0;

constexpr float kSin2Floor = 1e-15f;
constexpr float kPi = (float)3.14159265358979323846;

// Dormand-Prince 4(5) tableau (ops/tableau.py), double values rounded once.
constexpr float A21 = (float)(1.0 / 5.0);
constexpr float A31 = (float)(3.0 / 40.0), A32 = (float)(9.0 / 40.0);
constexpr float A41 = (float)(44.0 / 45.0), A42 = (float)(-56.0 / 15.0),
                A43 = (float)(32.0 / 9.0);
constexpr float A51 = (float)(19372.0 / 6561.0),
                A52 = (float)(-25360.0 / 2187.0),
                A53 = (float)(64448.0 / 6561.0), A54 = (float)(-212.0 / 729.0);
constexpr float A61 = (float)(9017.0 / 3168.0), A62 = (float)(-355.0 / 33.0),
                A63 = (float)(46732.0 / 5247.0), A64 = (float)(49.0 / 176.0),
                A65 = (float)(-5103.0 / 18656.0);
constexpr float B1 = (float)(35.0 / 384.0), B3 = (float)(500.0 / 1113.0),
                B4 = (float)(125.0 / 192.0), B5 = (float)(-2187.0 / 6784.0),
                B6 = (float)(11.0 / 84.0);
constexpr float E1 = (float)(71.0 / 57600.0), E3 = (float)(-71.0 / 16695.0),
                E4 = (float)(71.0 / 1920.0), E5 = (float)(-17253.0 / 339200.0),
                E6 = (float)(22.0 / 525.0), E7 = (float)(-1.0 / 40.0);

struct Params {
  float M, a, r_plus, r_obs, theta_obs, lambda_max;
  int max_steps;
  float atol, rtol, atol_ref, rtol_ref, h_min, tiny_err;
  float h_init, r_capture;
};

// NaN-propagating max/min/clip (jnp.maximum / jnp.minimum / jnp.clip).
__device__ __forceinline__ float jmax(float x, float y) {
  return (x > y || x != x) ? x : y;
}
__device__ __forceinline__ float jmin(float x, float y) {
  return (x < y || x != x) ? x : y;
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// False for NaN and +-inf (the comparison is false for NaN).
__device__ __forceinline__ bool is_finite_f(float x) {
  return fabsf(x) <= 3.402823466e+38f;
}

template <int N>
__device__ __forceinline__ bool all_finite(const float (&y)[N]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) ok = ok && is_finite_f(y[i]);
  return ok;
}

// Hamilton's equations on the reduced theta-state (models/kerr.py rhs5),
// hard-zeroed inside r <= 1.001 r_+.
__device__ __forceinline__ void rhs5(const float y[5], float p_t, float p_phi,
                                     const Params& P, float out[5]) {
  const float M = P.M, a = P.a;
  const float r = y[0], th = y[1], p_r = y[3], p_th = y[4];
  const bool frozen = r <= P.r_plus * 1.001f;
  const float r_s = frozen ? 10.0f * P.r_plus + 10.0f : r;

  const float sin_th = sinf(th);
  const float cos_th = cosf(th);
  const float sin2 = jmax(sin_th * sin_th, kSin2Floor);
  const float a2 = a * a;
  const float r2 = r_s * r_s;
  const float Sigma = r2 + a2 * cos_th * cos_th;
  const float Delta = r2 - 2.0f * M * r_s + a2;
  const float ra2 = r2 + a2;
  const float A = ra2 * ra2 - a2 * Delta * sin2;

  const float inv_Sigma = 1.0f / Sigma;
  const float inv_Delta = 1.0f / Delta;
  const float inv_sin2 = 1.0f / sin2;
  const float inv_SD = inv_Sigma * inv_Delta;
  const float inv_SD2 = inv_SD * inv_SD;
  const float inv_S2 = inv_Sigma * inv_Sigma;

  const float g_rr = Delta * inv_Sigma;
  const float g_thth = inv_Sigma;
  const float g_tphi = -2.0f * M * a * r_s * inv_SD;
  const float g_phiphi = (Delta - a2 * sin2) * inv_SD * inv_sin2;

  const float dr = g_rr * p_r;
  const float dth = g_thth * p_th;
  const float dphi = g_tphi * p_t + g_phiphi * p_phi;

  // radial derivatives of the inverse metric
  const float SD = Sigma * Delta;
  const float dSigma_dr = 2.0f * r_s;
  const float dDelta_dr = 2.0f * r_s - 2.0f * M;
  const float dA_dr = 4.0f * r_s * ra2 - a2 * dDelta_dr * sin2;
  const float dSD_dr = dSigma_dr * Delta + Sigma * dDelta_dr;

  const float dg_tt_dr = -(dA_dr * SD - A * dSD_dr) * inv_SD2;
  const float dg_tphi_dr = -(2.0f * M * a * (SD - r_s * dSD_dr)) * inv_SD2;
  const float dg_rr_dr = (dDelta_dr * Sigma - Delta * dSigma_dr) * inv_S2;
  const float dg_thth_dr = -dSigma_dr * inv_S2;
  const float inv_den_phi = inv_SD * inv_sin2;
  const float inv_den_phi2 = inv_den_phi * inv_den_phi;
  const float den_phi = SD * sin2;
  const float dg_phiphi_dr =
      (dDelta_dr * den_phi - (Delta - a2 * sin2) * dSD_dr * sin2) *
      inv_den_phi2;

  const float dp_r =
      -0.5f * (dg_tt_dr * p_t * p_t + 2.0f * dg_tphi_dr * p_t * p_phi +
               dg_rr_dr * p_r * p_r + dg_thth_dr * p_th * p_th +
               dg_phiphi_dr * p_phi * p_phi);

  // polar derivatives of the inverse metric
  const float sc = sin_th * cos_th;
  const float dSigma_dth = -2.0f * a2 * sc;
  const float dA_dth = -2.0f * a2 * Delta * sc;

  const float dg_tt_dth = -(dA_dth * SD - A * dSigma_dth * Delta) * inv_SD2;
  const float dg_tphi_dth =
      (2.0f * M * a * r_s * dSigma_dth) * inv_S2 * inv_Delta;
  const float dg_rr_dth = -Delta * dSigma_dth * inv_S2;
  const float dg_thth_dth = -dSigma_dth * inv_S2;

  const float num = Delta - a2 * sin2;
  const float dnum_dth = -2.0f * a2 * sc;
  const float dden_dth = dSigma_dth * Delta * sin2 + 2.0f * SD * sc;
  const float dg_phiphi_dth = (dnum_dth * den_phi - num * dden_dth) *
                              inv_den_phi2;

  const float dp_th =
      -0.5f * (dg_tt_dth * p_t * p_t + 2.0f * dg_tphi_dth * p_t * p_phi +
               dg_rr_dth * p_r * p_r + dg_thth_dth * p_th * p_th +
               dg_phiphi_dth * p_phi * p_phi);

  out[0] = frozen ? 0.0f : dr;
  out[1] = frozen ? 0.0f : dth;
  out[2] = frozen ? 0.0f : dphi;
  out[3] = frozen ? 0.0f : dp_r;
  out[4] = frozen ? 0.0f : dp_th;
}

// Step fraction where the cubic Hermite interpolant of r crosses target:
// four clamped Newton iterations from the linear estimate, which is kept
// when the result is not finite.
__device__ __forceinline__ float hermite_crossing_frac(
    float r0, float r1, float fr0, float fr1, float h, float target,
    float frac_linear) {
  float s = frac_linear;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const float s2 = s * s;
    const float p = (2.0f * s2 * s - 3.0f * s2 + 1.0f) * r0 +
                    (s2 * s - 2.0f * s2 + s) * h * fr0 +
                    (-2.0f * s2 * s + 3.0f * s2) * r1 +
                    (s2 * s - s2) * h * fr1;
    const float dp = (6.0f * s2 - 6.0f * s) * r0 +
                     (3.0f * s2 - 4.0f * s + 1.0f) * h * fr0 +
                     (-6.0f * s2 + 6.0f * s) * r1 +
                     (3.0f * s2 - 2.0f * s) * h * fr1;
    const bool ok = fabsf(dp) > 1e-30f;
    const float step = ok ? (p - target) / dp : 0.0f;
    s = jclip(s - step, 0.0f, 1.0f);
  }
  return is_finite_f(s) ? s : frac_linear;
}

// A ray's start at the observer (models/kerr.py initial_conditions_5d):
// the reduced state, the conserved momenta, and the observer terms the
// shadow variant's plunge radius reuses.
struct RayStart {
  float y[5];
  float p_t, p_phi;
  bool bad_obs;
  float sin_al, sin_scr, cos_scr, cos_th, Sigma, Delta;
};

// Bardeen initial conditions for screen angle al and azimuth scr.
__device__ __forceinline__ RayStart initial_state(float al, float scr,
                                                  const Params& P) {
  const float M = P.M, a = P.a;
  RayStart S;
  const float r = P.r_obs, th = P.theta_obs;
  const float sin_th = sinf(th), cos_th = cosf(th);
  const float sin2 = jmax(sin_th * sin_th, kSin2Floor);
  const float Sigma = r * r + a * a * cos_th * cos_th;
  const float Delta = r * r - 2.0f * M * r + a * a;
  const bool bad_obs = (Delta <= 0.0f) || (Sigma <= 0.0f);

  const float E = 1.0f;
  const float sin_al = sinf(al);
  const float rho =
      r * sin_al * sqrtf(Sigma) / sqrtf(bad_obs ? 1.0f : Delta);
  const float sin_scr = sinf(scr), cos_scr = cosf(scr);
  const float alpha_s = -rho * sin_scr;
  const float beta_s = -rho * cos_scr;
  const float xi = -alpha_s * sin_th;
  const float eta =
      beta_s * beta_s + cos_th * cos_th * (alpha_s * alpha_s - a * a);
  const float L = xi * E;
  const float Q = eta * E * E;
  const float p_t = -E;
  const float p_phi = L;
  const float Theta =
      jmax(Q - cos_th * cos_th * (L * L / sin2 - a * a * E * E), 0.0f);
  const float p_th0 = (cos_scr > 0.0f ? -1.0f : 1.0f) * sqrtf(Theta);

  // inverse metric at the observer
  const float r2 = r * r, a2 = a * a;
  const float Sg = r2 + a2 * cos_th * cos_th;
  const float Dl = r2 - 2.0f * M * r + a2;
  const float ra2 = r2 + a2;
  const float A = ra2 * ra2 - a2 * Dl * sin2;
  const float SD = Sg * Dl;
  const float g_tt = -A / SD;
  const float g_tphi = -2.0f * M * a * r / SD;
  const float g_rr = Dl / Sg;
  const float g_thth = 1.0f / Sg;
  const float g_phiphi = (Dl - a2 * sin2) / (SD * sin2);
  const float other = g_tt * p_t * p_t + 2.0f * g_tphi * p_t * p_phi +
                      g_thth * p_th0 * p_th0 + g_phiphi * p_phi * p_phi;
  const float p_r_sq = -other / g_rr;
  const float p_r0 =
      (cosf(al) >= 0.0f ? -1.0f : 1.0f) * sqrtf(jmax(p_r_sq, 0.0f));

  S.y[0] = r;
  S.y[1] = th;
  S.y[2] = 0.0f;
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

}  // namespace
