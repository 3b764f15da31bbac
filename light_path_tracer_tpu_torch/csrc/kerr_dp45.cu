// Kerr adaptive Dormand-Prince 4(5) ray kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py::_trace_tile_kernel
//   (entry trace_rays_kerr_pallas),
// written from what that kernel computes, not from its tiling. The plain
// PyTorch version is light_path_tracer_tpu_torch/ops/kerr_trace.py
// (trace_rays_kerr); the wrapper is ops/cuda/kerr_trace_kernel.py.
//
// Work: one CUDA thread per ray, 128 threads per block, grid = ceil(n/128).
// Each thread computes its ray's Bardeen initial conditions and its
// certain-plunge radius (acosf exists here, so neither leaves the kernel
// as it must under Mosaic), then runs its own adaptive DP45 + FSAL loop
// over (r, theta, phi, p_r, p_theta) until the ray is captured, escapes or
// goes invalid, max_steps attempts are spent, or lambda >= lambda_max. It
// writes the final state, the status and its attempt count; the escape
// angle is extracted afterwards in torch, as the JAX wrapper does.
//
// What bounds it: arithmetic. Each attempt makes 6 new RHS evaluations,
// each with a sinf, a cosf and three reciprocals, while a ray moves only
// about 40 bytes through device memory in the whole run (9 bytes in, 28
// out). The state lives in registers for the whole loop. The cost that
// matters is warp divergence: a warp runs until its slowest lane is done,
// and ray lifetimes range from tens of attempts to the full budget. The
// raster order of an image grid keeps neighbouring rays similar in
// difficulty, so consecutive rays share a warp; this first version does
// nothing beyond that (no compaction, no persistent scheduling).
//
// Numerics follow the float32 path of the JAX package's dp45_integrate:
// the tableau is the double coefficients rounded to float, stage sums are
// taken as c0 k0 + c1 k1 + ... and then multiplied by h, and the max/min/
// clip helpers propagate NaN as jnp.maximum/minimum/clip do. Build without
// --use_fast_math: the approximate __sinf/__cosf lose accuracy once |theta|
// or |phi| grows (over-the-pole rays in the double-cover chart). nvcc
// contracts a*b + c into FMA by default, so results are close to, not
// bitwise equal to, the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

constexpr int kRunning = 2;
constexpr int kEscaped = 1;
constexpr int kCaptured = -1;
constexpr int kInvalid = 0;

constexpr float kSin2Floor = 1e-15f;

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

__device__ __forceinline__ bool all_finite(const float y[5]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 5; ++i) ok = ok && is_finite_f(y[i]);
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

__global__ void __launch_bounds__(kThreads)
kerr_dp45_kernel(const float* __restrict__ alpha,
                 const float* __restrict__ theta,
                 const unsigned char* __restrict__ refine,
                 float* __restrict__ r_out, float* __restrict__ th_out,
                 float* __restrict__ phi_out, float* __restrict__ pr_out,
                 float* __restrict__ pth_out, int* __restrict__ status_out,
                 int* __restrict__ steps_out, int n, Params P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float M = P.M, a = P.a;
  const float al = alpha[i];
  const float scr = theta[i];
  const bool ref = refine[i] != 0;
  const float atol = ref ? P.atol_ref : P.atol;
  const float rtol = ref ? P.rtol_ref : P.rtol;

  // ---- Bardeen initial conditions (models/kerr.py initial_conditions_5d)
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

  // ---- certain-plunge radius (models/kerr.py plunge_radii)
  const float rho_p = r * sin_al * sqrtf(Sigma) / sqrtf(jmax(Delta, 1e-30f));
  const float as_p = -rho_p * sin_scr;
  const float bs_p = -rho_p * cos_scr;
  const float eta_p = bs_p * bs_p + cos_th * cos_th * (as_p * as_p - a * a);
  const float ratio = jclip(-a / jmax(M, 1e-30f), -1.0f, 1.0f);
  const float r_pro =
      2.0f * M * (1.0f + cosf((float)(2.0 / 3.0) * acosf(ratio)));
  const float r_plunge = eta_p >= 0.0f ? 0.999f * r_pro : 0.0f;

  const float r_capture = P.r_capture;
  const float r_escape = P.r_obs * 2.0f;
  const float lam_max = P.lambda_max;

  // ---- adaptive DP45 + FSAL loop (ops/kerr_trace.py dp45_integrate)
  float y[5] = {r, th, 0.0f, p_r0, p_th0};
  float k1[5];
  rhs5(y, p_t, p_phi, P, k1);
  float h = P.h_init;
  float lam = 0.0f;
  int status = bad_obs ? kInvalid : kRunning;
  int steps = 0;

  while (steps < P.max_steps && status == kRunning && lam < lam_max) {
    ++steps;
    const float h_eff = jmax(jmin(h, lam_max - lam), 0.0f);

    float yt[5], k2[5], k3[5], k4[5], k5[5], k6[5], k7[5], y5[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) yt[c] = y[c] + h_eff * (A21 * k1[c]);
    rhs5(yt, p_t, p_phi, P, k2);
#pragma unroll
    for (int c = 0; c < 5; ++c)
      yt[c] = y[c] + h_eff * (A31 * k1[c] + A32 * k2[c]);
    rhs5(yt, p_t, p_phi, P, k3);
#pragma unroll
    for (int c = 0; c < 5; ++c)
      yt[c] = y[c] + h_eff * (A41 * k1[c] + A42 * k2[c] + A43 * k3[c]);
    rhs5(yt, p_t, p_phi, P, k4);
#pragma unroll
    for (int c = 0; c < 5; ++c)
      yt[c] = y[c] + h_eff * (A51 * k1[c] + A52 * k2[c] + A53 * k3[c] +
                              A54 * k4[c]);
    rhs5(yt, p_t, p_phi, P, k5);
#pragma unroll
    for (int c = 0; c < 5; ++c)
      yt[c] = y[c] + h_eff * (A61 * k1[c] + A62 * k2[c] + A63 * k3[c] +
                              A64 * k4[c] + A65 * k5[c]);
    rhs5(yt, p_t, p_phi, P, k6);
#pragma unroll
    for (int c = 0; c < 5; ++c)
      y5[c] = y[c] + h_eff * (B1 * k1[c] + B3 * k3[c] + B4 * k4[c] +
                              B5 * k5[c] + B6 * k6[c]);
    rhs5(y5, p_t, p_phi, P, k7);

    const bool finite_ok = all_finite(y5) && (y5[0] > 0.0f);

    // increment-aware float32 error scale and embedded error norm
    float err_sq = 0.0f;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float mag = jmax(fabsf(y[c]), fabsf(y5[c]));
      mag = mag + h_eff * jmax(fabsf(k1[c]), fabsf(k7[c]));
      const float scale = atol + rtol * mag;
      const float err = h_eff * (E1 * k1[c] + E3 * k3[c] + E4 * k4[c] +
                                 E5 * k5[c] + E6 * k6[c] + E7 * k7[c]);
      const float q = finite_ok ? err / scale : 0.0f;
      err_sq = err_sq + q * q;
    }
    const float err_norm = sqrtf(err_sq / 5.0f);

    const bool accept = finite_ok && (err_norm <= 1.0f);
    const bool reject = finite_ok && (err_norm > 1.0f);
    const bool blowup = !finite_ok;

    // events on accepted steps (capture has priority over escape)
    const float r_prev = y[0], r_next = y5[0];
    const bool cap = accept && ((r_prev > r_capture && r_next <= r_capture) ||
                                (r_next <= r_plunge && r_next < r_prev));
    const bool esc =
        accept && r_prev < r_escape && r_next >= r_escape && !cap;
    const bool event = cap || esc;

    float frac = 1.0f;
    float y_acc[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) y_acc[c] = y5[c];
    if (event) {
      const float denom = r_next - r_prev;
      const float target = cap ? r_capture : r_escape;
      const float frac_lin =
          denom == 0.0f ? 1.0f : jclip((target - r_prev) / denom, 0.0f, 1.0f);
      frac = hermite_crossing_frac(r_prev, r_next, k1[0], k7[0], h_eff, target,
                                   frac_lin);
      const float s2 = frac * frac, s3 = s2 * frac;
      const float h00 = 2.0f * s3 - 3.0f * s2 + 1.0f;
      const float h10 = s3 - 2.0f * s2 + frac;
      const float h01 = -2.0f * s3 + 3.0f * s2;
      const float h11 = s3 - s2;
#pragma unroll
      for (int c = 0; c < 5; ++c)
        y_acc[c] = h00 * y[c] + h10 * h_eff * k1[c] + h01 * y5[c] +
                   h11 * h_eff * k7[c];
    }

    // step-size control (one pow serves both shrink and grow)
    const float factor = 0.9f * powf(jmax(err_norm, 1e-30f), -0.2f);
    const float shrink = jmax(0.2f, factor);
    const float grow = err_norm < P.tiny_err ? 5.0f : jmin(5.0f, factor);
    const float h_new =
        accept ? h * grow : (reject ? h * shrink : (blowup ? h * 0.25f : h));
    const bool underflow = (reject || blowup) && (h_new < P.h_min);

    if (accept) {
      const bool corrupt = !all_finite(y_acc);
      lam = lam + frac * h_eff;
#pragma unroll
      for (int c = 0; c < 5; ++c) y[c] = y_acc[c];
      // FSAL: stage 7 seeds the next step's stage 1, except after events.
      if (!event) {
#pragma unroll
        for (int c = 0; c < 5; ++c) k1[c] = k7[c];
      }
      if (cap) status = kCaptured;
      else if (esc) status = kEscaped;
      if (corrupt) status = kInvalid;
    }
    if (underflow) status = kInvalid;
    h = h_new;
  }

  r_out[i] = y[0];
  th_out[i] = y[1];
  phi_out[i] = y[2];
  pr_out[i] = y[3];
  pth_out[i] = y[4];
  status_out[i] = status;
  steps_out[i] = steps;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers; refine is one byte per ray.
int lpt_kerr_dp45(const void* alpha, const void* theta, const void* refine,
                  void* r_out, void* th_out, void* phi_out, void* pr_out,
                  void* pth_out, void* status_out, void* steps_out, int n,
                  float M, float a, float r_plus, float r_obs,
                  float theta_obs, float lambda_max, int max_steps,
                  float atol, float rtol, float atol_ref, float rtol_ref,
                  float h_min, float tiny_err, float h_init, float r_capture,
                  void* stream) {
  if (n <= 0) return 0;
  Params P{M,    a,     r_plus,   r_obs,    theta_obs, lambda_max,
           max_steps, atol, rtol, atol_ref, rtol_ref,  h_min,
           tiny_err, h_init, r_capture};
  const int blocks = (n + kThreads - 1) / kThreads;
  kerr_dp45_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(theta),
      static_cast<const unsigned char*>(refine), static_cast<float*>(r_out),
      static_cast<float*>(th_out), static_cast<float*>(phi_out),
      static_cast<float*>(pr_out), static_cast<float*>(pth_out),
      static_cast<int*>(status_out), static_cast<int*>(steps_out), n, P);
  return static_cast<int>(cudaGetLastError());
}

const char* lpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
