// The Kerr adaptive Dormand-Prince 4(5) ray kernel with error-controlled
// extra state components, for Hopper (sm_90a): the part every transfer
// family shares. A family's source file (kerr_dp45_extras.cu: thin,
// self-absorbed, spectral; kerr_dp45_stokes.cu; kerr_dp45_movie_*.cu;
// kerr_dp45_orders.cu) defines its functors and one C entry point, so the
// families compile side by side.
//
// Here: the transfer constants (RiafParams), the rest-frame emissivity
// profiles and the emitter redshifts, the ray kernel (initial conditions,
// the adaptive DP45 + FSAL loop over 5 + kExtras components, the
// saturation and frozen-state exits, the angle extraction), and the
// launch helpers. A functor is
//   struct F { static constexpr int kExtras, kAux;
//              static void eval(y, p_t, p_phi, P, R, aux, d); }
// with d the kExtras derivatives at state y and aux the ray's kAux
// per-ray constants (read once into registers).
//
// Saturation and frozen-state exits (sat_window > 0, ops/kerr_trace.py
// dp45_integrate): a ray whose monitored extras have not changed for
// sat_window consecutive attempts while r <= sat_r_max, or whose whole
// state has not changed for sat_window attempts anywhere, ends with
// lambda = lambda_max. The test compares the accepted state with the old
// one value by value; a rejected attempt keeps the old registers untouched,
// so contraction into FMA cannot make a frozen state look changed.
//
// Numerics follow the float32 path of the JAX package (see
// kerr_dp45_common.cuh): every Python-float constant of the JAX transfer
// functions arrives here formed in double and rounded once (the wrapper
// computes RiafParams in double), r^1.5 and g^p are powf, sigmoid is
// 1 / (1 + exp(-x)).

#pragma once

#include "kerr_dp45_common.cuh"

namespace {

constexpr int kMaxBands = 8;
constexpr int kMaxFrames = 8;
constexpr int kMaxAux = 4;

enum Profile { kTorus = 0, kPowerlaw = 1, kShell = 2, kJet = 3 };
enum Field { kVertical = 0, kToroidal = 1, kRadial = 2 };

// The transfer function's constants (volumetric.py), each formed in
// double on the host and rounded once.
struct RiafParams {
  int profile;     // Profile
  int geometry;    // 1: g_power == 0, path length only (no redshift)
  float two_M, a, a2;       // 2 M, a, a^2
  float kep_num, kep_add;   // Omega_K = kep_num / (r^1.5 + kep_add)
  float r_peak, two_sig_r2, two_h2, index;
  float shell_in, shell_out, edge_width;
  float jet_cos, two_jet_sig2, jet_r_base, jet_beta, jet_gamma;
  float g_power, alpha0;
  float q_minus_1, tau_floor;  // spectral: g^(q-1), the tau_hat floor
  float neg_c[kMaxBands];      // spectral: -f_i^(1-q)
  float band_scale[kMaxBands]; // spectral: f_i^-s
  // movie: the blob's peak, phase, Omega_K(spot_r), spot_r, spot_r^2 and
  // 2 sigma^2, and the frames' observer times
  float spot_amp, spot_phase, spot_omega, spot_r, spot_r2, two_spot_sig2;
  float times[kMaxFrames];
  // order decomposition: the crossing bump's norm and 1 / (2 sigma^2)
  float order_norm, order_inv_two_sig2;
  // Stokes: the field geometry (Field), 2 M a, 2 M a^2, the flow's sense
  // (+-1) and the polarization fraction of an emission element
  int field;
  float two_Ma, two_Ma2, flow_sign, p0;
};

// The saturation and frozen-state exits: off when window == 0; monitor is
// a bit mask over the extras.
struct SatParams {
  int window;
  unsigned int monitor;
  float r_max;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Rest-frame emissivity j(r, cos theta) (volumetric._profile_fns).
__device__ __forceinline__ float j_rest(float r, float c,
                                        const RiafParams& R) {
  switch (R.profile) {
    case kTorus: {
      const float d = r - R.r_peak;
      return expf(-(d * d) / R.two_sig_r2 - c * c / R.two_h2);
    }
    case kPowerlaw:
      return powf(jmax(r, 1e-3f) / R.r_peak, R.index) *
             expf(-c * c / R.two_h2);
    case kJet: {
      const float d = fabsf(c) - R.jet_cos;
      return expf(-(d * d) / R.two_jet_sig2) *
             powf(jmax(r, 1e-3f) / R.r_peak, R.index) *
             sigmoid_f((r - R.jet_r_base) / R.edge_width);
    }
    default:
      return sigmoid_f((r - R.shell_in) / R.edge_width) *
             sigmoid_f((R.shell_out - r) / R.edge_width);
  }
}

// Circular-emitter redshift g = nu_obs / nu_em off the plane, clipped to
// [0, 10]: Keplerian where that orbit is timelike, ZAMO inside.
__device__ __forceinline__ float g_circular(float r, float c, float p_t,
                                            float p_phi,
                                            const RiafParams& R) {
  const float s2 = jmax(1.0f - c * c, 1e-12f);
  const float W = R.two_M * r;
  const float Delta = r * r - R.two_M * r + R.a2;
  const float ra2 = r * r + R.a2;
  const float A = ra2 * ra2 - R.a2 * Delta * s2;
  // covariant t-phi block (disk.covariant_tphi_components)
  const float Sigma = r * r + R.a2 * c * c;
  const float g_tt = -(1.0f - W / Sigma);
  const float g_tph = -R.a * W * s2 / Sigma;
  const float g_pp = (ra2 + R.a2 * W * s2 / Sigma) * s2;
  const float om_k = R.kep_num / (powf(r, 1.5f) + R.kep_add);
  const float om_z = R.a * W / jmax(A, 1e-30f);
  const float tl_k = -(g_tt + 2.0f * om_k * g_tph + om_k * om_k * g_pp);
  const float om = tl_k > 1e-3f ? om_k : om_z;
  const float den =
      jmax(-(g_tt + 2.0f * om * g_tph + om * om * g_pp), 1e-12f);
  const float xi = p_phi / jmax(-p_t, 1e-30f);
  const float g = sqrtf(den) / jmax(1.0f - om * xi, 1e-3f);
  return jclip(g, 0.0f, 10.0f);
}

// Redshift of the jet's emitter, moving radially outward at jet_beta in
// the ZAMO frame (p_r is the traced radial momentum), clipped to [0, 10].
__device__ __forceinline__ float g_jet(float r, float c, float p_r,
                                       float p_t, float p_phi,
                                       const RiafParams& R) {
  const float s2 = jmax(1.0f - c * c, 1e-12f);
  const float W = R.two_M * r;
  const float Delta = jmax(r * r - R.two_M * r + R.a2, 1e-12f);
  const float Sigma = jmax(r * r + R.a2 * c * c, 1e-12f);
  const float ra2 = r * r + R.a2;
  const float A = jmax(ra2 * ra2 - R.a2 * Delta * s2, 1e-30f);
  const float om = R.a * W / A;
  const float alpha_lapse = sqrtf(Sigma * Delta / A);
  const float e_inv = jmax(-p_t, 1e-30f);
  const float xi = p_phi / e_inv;
  const float inv_g =
      R.jet_gamma * ((1.0f - om * xi) / jmax(alpha_lapse, 1e-6f) +
                     R.jet_beta * sqrtf(Delta / Sigma) * p_r / e_inv);
  const float g = 1.0f / jmax(inv_g, 0.1f);
  return jclip(g, 0.0f, 10.0f);
}

// The rest-frame emissivity j, the emitter redshift g, the redshift
// weight w = g^p and the emission em = j w at state y; g and w are 1 in
// the pure-geometry mode.
struct Source {
  float j, g, w, em;
};

__device__ __forceinline__ Source source(const float* y, float p_t,
                                         float p_phi, const RiafParams& R) {
  const float c = cosf(y[1]);
  Source s;
  s.j = j_rest(y[0], c, R);
  if (R.geometry) {
    s.g = 1.0f;
    s.w = 1.0f;
    s.em = s.j;
  } else {
    s.g = R.profile == kJet ? g_jet(y[0], c, y[3], p_t, p_phi, R)
                            : g_circular(y[0], c, p_t, p_phi, R);
    s.w = powf(s.g, R.g_power);
    s.em = s.j * s.w;
  }
  return s;
}

// The invariant opacity chi = alpha0 j / max(g, 0.1) (alpha0 j in the
// pure-geometry mode) of the single-band, movie and order forms.
__device__ __forceinline__ float opacity(const Source& s,
                                         const RiafParams& R) {
  return R.geometry ? R.alpha0 * s.j : R.alpha0 * s.j / jmax(s.g, 0.1f);
}

// The full right-hand side: the geodesic's five components, then the
// functor's extras. aux holds the ray's T::kAux per-ray constants.
template <class T, int N>
__device__ __forceinline__ void rhs_full(const float (&y)[N], float p_t,
                                         float p_phi, const Params& P,
                                         const RiafParams& R,
                                         const float* aux,
                                         float (&out)[N]) {
  rhs5(y, p_t, p_phi, P, out);
  T::eval(y, p_t, p_phi, P, R, aux, out + 5);
}

// Escape heading, half-orbit count and status fold of a finished ray
// (models/kerr.py extract_angle, then ops/kerr_trace.py finalize_angles),
// with M and a as float32 values as the torch version has them.
struct Final {
  float alpha;
  int n_half, status;
};

__device__ __forceinline__ Final finalize(const float* y, float p_t,
                                          float p_phi, int status_f,
                                          float r_reclass, const Params& P) {
  const float M = P.M, a = P.a;
  const float nan = __int_as_float(0x7fc00000);
  const float r_f = y[0], th_f = y[1], phi_f = y[2];
  int n_half = static_cast<int>(floorf(fabsf(phi_f) / kPi));
  const bool is_captured = status_f == kCaptured || r_f <= r_reclass;
  const bool bad_state =
      !(is_finite_f(r_f) && is_finite_f(th_f) && is_finite_f(phi_f));

  const float sin_th = sinf(th_f), cos_th = cosf(th_f);
  const float sin2 = jmax(sin_th * sin_th, kSin2Floor);
  const float r_s = (bad_state || is_captured) ? 10.0f * M + 10.0f : r_f;
  const float Sigma_f = r_s * r_s + a * a * cos_th * cos_th;
  const float Delta_f = r_s * r_s - 2.0f * M * r_s + a * a;
  const bool degenerate = Sigma_f <= 1e-15f || fabsf(Delta_f) <= 1e-15f;
  const float S = degenerate ? 1.0f : Sigma_f;
  const float D = degenerate ? 1.0f : Delta_f;

  const float dr_dl = D / S * y[3];
  const float dth_dl = y[4] / S;
  const float dphi_dl = -a * (2.0f * M * r_s) / (S * D) * p_t +
                        (D - a * a * sin2) / (S * D * sin2) * p_phi;
  const float sin_phi = sinf(phi_f), cos_phi = cosf(phi_f);
  const float vx = sin_th * cos_phi * dr_dl + r_s * cos_th * cos_phi * dth_dl -
                   r_s * sin_th * sin_phi * dphi_dl;
  const float vy = sin_th * sin_phi * dr_dl + r_s * cos_th * sin_phi * dth_dl +
                   r_s * sin_th * cos_phi * dphi_dl;
  const float vz = cos_th * dr_dl - r_s * sin_th * dth_dl;
  const bool bad_v = !(is_finite_f(vx) && is_finite_f(vy) && is_finite_f(vz));
  const float v_mag = sqrtf(vx * vx + vy * vy + vz * vz);
  const bool tiny_v = v_mag < 1e-30f;
  const float v_safe = tiny_v ? 1.0f : v_mag;
  float alpha = acosf(jclip(-vx / v_safe, -1.0f, 1.0f));
  const bool invalid = bad_state || degenerate || bad_v;
  const int ext_status = is_captured ? -1 : (invalid ? 0 : 1);
  if (bad_state && !is_captured) n_half = 0;

  const bool invalid_f = status_f == kInvalid || ext_status == 0;
  const bool cap_f = !invalid_f && ext_status == -1;
  Final F;
  F.status = invalid_f ? kInvalid : (cap_f ? kCaptured : kEscaped);
  F.alpha = (F.status == kEscaped && !tiny_v) ? alpha : nan;
  F.n_half = (invalid_f && status_f == kInvalid) ? 0 : n_half;
  return F;
}

// One call of a C entry point, filled by the Python wrapper
// (ops/cuda/volumetric_kernel.py ExtrasCall, field for field): device
// pointers, the stream, and the launch's scalars. aux[k] is the k-th
// per-ray float32 constant (null where the functor takes fewer); extras
// is (kExtras, n) float32, each extra zeroed where the integration went
// INVALID; flags bit 0 is "unconverged" (still RUNNING with lambda budget
// left: the two-pass drivers re-trace it), bit 1 the saturation exit,
// bit 2 the frozen-state exit; steps (the per-ray attempts) may be null;
// warp_steps is one int64, zeroed before the launch. form and variant
// pick the functor within a source file.
struct ExtrasCall {
  const float *alpha, *theta;
  const float* aux[kMaxAux];
  float *extras, *final_alpha;
  int *n_half, *status, *steps;
  unsigned char* flags;
  unsigned long long* warp_steps;
  void* stream;
  int n, form, variant, max_steps, sat_window;
  unsigned int sat_monitor;
  float M, a, r_plus, r_obs, theta_obs, lambda_max, atol, rtol, h_min,
      tiny_err, h_init, r_capture, r_reclass, sat_r_max;
};

// The wrapper mirrors both structs with ctypes: 4-byte members without
// padding, pointers first.
static_assert(sizeof(RiafParams) == 240, "RiafParams layout");
static_assert(sizeof(ExtrasCall) == 192, "ExtrasCall layout");

// The ray kernel, one thread per ray.
template <class T>
__global__ void __launch_bounds__(kThreads)
kerr_dp45_extras_kernel(ExtrasCall C, Params P, RiafParams R, SatParams S) {
  constexpr int N = 5 + T::kExtras;
  const int n = C.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0;

  if (i < n) {
    const RayStart S0 = initial_state(C.alpha[i], C.theta[i], P);
    // The ray's auxiliary constants, read once into registers.
    float aux[T::kAux > 0 ? T::kAux : 1];
#pragma unroll
    for (int k = 0; k < T::kAux; ++k) aux[k] = C.aux[k][i];
    const float p_t = S0.p_t, p_phi = S0.p_phi;
    const float r_capture = P.r_capture;
    const float r_escape = P.r_obs * 2.0f;
    const float lam_max = P.lambda_max;

    float y[N];
#pragma unroll
    for (int c = 0; c < N; ++c) y[c] = c < 5 ? S0.y[c] : 0.0f;
    float k1[N];
    rhs_full<T>(y, p_t, p_phi, P, R, aux, k1);
    float h = P.h_init;
    float lam = 0.0f;
    int status = S0.bad_obs ? kInvalid : kRunning;
    int sat_cnt = 0, frz_cnt = 0;
    unsigned int flags = 0;

    // ---- adaptive DP45 + FSAL loop (ops/kerr_trace.py dp45_integrate)
    while (steps < P.max_steps && status == kRunning && lam < lam_max) {
      ++steps;
      const float h_eff = jmax(jmin(h, lam_max - lam), 0.0f);

      float yt[N], k2[N], k3[N], k4[N], k5[N], k6[N], y5[N], k7[N];
#pragma unroll
      for (int c = 0; c < N; ++c) yt[c] = y[c] + h_eff * (A21 * k1[c]);
      rhs_full<T>(yt, p_t, p_phi, P, R, aux, k2);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (A31 * k1[c] + A32 * k2[c]);
      rhs_full<T>(yt, p_t, p_phi, P, R, aux, k3);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (A41 * k1[c] + A42 * k2[c] + A43 * k3[c]);
      rhs_full<T>(yt, p_t, p_phi, P, R, aux, k4);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (A51 * k1[c] + A52 * k2[c] + A53 * k3[c] +
                                A54 * k4[c]);
      rhs_full<T>(yt, p_t, p_phi, P, R, aux, k5);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (A61 * k1[c] + A62 * k2[c] + A63 * k3[c] +
                                A64 * k4[c] + A65 * k5[c]);
      rhs_full<T>(yt, p_t, p_phi, P, R, aux, k6);
#pragma unroll
      for (int c = 0; c < N; ++c)
        y5[c] = y[c] + h_eff * (B1 * k1[c] + B3 * k3[c] + B4 * k4[c] +
                                B5 * k5[c] + B6 * k6[c]);
      rhs_full<T>(y5, p_t, p_phi, P, R, aux, k7);

      const bool finite_ok = all_finite(y5) && (y5[0] > 0.0f);

      // increment-aware float32 error scale, error norm over N components
      float err_sq = 0.0f;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        float mag = jmax(fabsf(y[c]), fabsf(y5[c]));
        mag = mag + h_eff * jmax(fabsf(k1[c]), fabsf(k7[c]));
        const float scale = P.atol + P.rtol * mag;
        const float err = h_eff * (E1 * k1[c] + E3 * k3[c] + E4 * k4[c] +
                                   E5 * k5[c] + E6 * k6[c] + E7 * k7[c]);
        const float q = finite_ok ? err / scale : 0.0f;
        err_sq = err_sq + q * q;
      }
      const float err_norm = sqrtf(err_sq / static_cast<float>(N));

      const bool accept = finite_ok && (err_norm <= 1.0f);
      const bool reject = finite_ok && (err_norm > 1.0f);
      const bool blowup = !finite_ok;

      // events on accepted steps (capture has priority; no plunge exit:
      // plunging rays collect emission down to the capture surface)
      const float r_prev = y[0], r_next = y5[0];
      const bool cap = accept && r_prev > r_capture && r_next <= r_capture;
      const bool esc =
          accept && r_prev < r_escape && r_next >= r_escape && !cap;
      const bool event = cap || esc;

      float frac = 1.0f;
      float (&y_acc)[N] = yt;  // the stage scratch is free again
#pragma unroll
      for (int c = 0; c < N; ++c) y_acc[c] = y5[c];
      if (event) {
        const float denom = r_next - r_prev;
        const float target = cap ? r_capture : r_escape;
        const float frac_lin =
            denom == 0.0f ? 1.0f
                          : jclip((target - r_prev) / denom, 0.0f, 1.0f);
        frac = hermite_crossing_frac(r_prev, r_next, k1[0], k7[0], h_eff,
                                     target, frac_lin);
        const float s2 = frac * frac, s3 = s2 * frac;
        const float h00 = 2.0f * s3 - 3.0f * s2 + 1.0f;
        const float h10 = s3 - 2.0f * s2 + frac;
        const float h01 = -2.0f * s3 + 3.0f * s2;
        const float h11 = s3 - s2;
#pragma unroll
        for (int c = 0; c < N; ++c)
          y_acc[c] = h00 * y[c] + h10 * h_eff * k1[c] + h01 * y5[c] +
                     h11 * h_eff * k7[c];
      }

      // step-size control (one pow serves both shrink and grow)
      const float factor = 0.9f * powf(jmax(err_norm, 1e-30f), -0.2f);
      const float shrink = jmax(0.2f, factor);
      const float grow = err_norm < P.tiny_err ? 5.0f : jmin(5.0f, factor);
      const float h_new =
          accept ? h * grow : (reject ? h * shrink : (blowup ? h * 0.25f : h));

      bool changed_mon = false, changed_any = false;
      if (accept) {
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const bool d = y_acc[c] != y[c];
          changed_any = changed_any || d;
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

      if (S.window > 0) {
        sat_cnt = changed_mon ? 0 : sat_cnt + 1;
        frz_cnt = changed_any ? 0 : frz_cnt + 1;
        if (status == kRunning) {
          const bool sat = sat_cnt >= S.window && y[0] <= S.r_max;
          const bool frz = frz_cnt >= S.window;
          if (sat || frz) {
            lam = lam_max;
            flags |= (sat ? 2u : 0u) | (frz ? 4u : 0u);
          }
        }
      }
    }

    if (status == kRunning && lam < lam_max) flags |= 1u;
    const Final F = finalize(y, p_t, p_phi, status, C.r_reclass, P);
#pragma unroll
    for (int e = 0; e < T::kExtras; ++e)
      C.extras[static_cast<size_t>(e) * n + i] =
          status == kInvalid ? 0.0f : y[5 + e];
    C.final_alpha[i] = F.alpha;
    C.n_half[i] = F.n_half;
    C.status[i] = F.status;
    C.flags[i] = static_cast<unsigned char>(flags);
    if (C.steps != nullptr) C.steps[i] = steps;
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
// launch<T>() starts the kernel for one functor.
struct Prepared {
  Params P;
  RiafParams R;
  SatParams S;
};

inline bool begin(const ExtrasCall& C, const void* riaf, Prepared* out,
                  cudaError_t* err) {
  *err = cudaMemsetAsync(C.warp_steps, 0, sizeof(unsigned long long),
                         static_cast<cudaStream_t>(C.stream));
  if (*err != cudaSuccess || C.n <= 0) return false;
  out->P = Params{C.M,    C.a,    C.r_plus, C.r_obs, C.theta_obs,
                  C.lambda_max, C.max_steps, C.atol, C.rtol, C.atol,
                  C.rtol, C.h_min, C.tiny_err, C.h_init, C.r_capture};
  out->R = *static_cast<const RiafParams*>(riaf);
  out->S = SatParams{C.sat_window, C.sat_monitor, C.sat_r_max};
  return true;
}

template <class T>
void launch(const ExtrasCall& C, const Prepared& K) {
  kerr_dp45_extras_kernel<T>
      <<<(C.n + kThreads - 1) / kThreads, kThreads, 0,
         static_cast<cudaStream_t>(C.stream)>>>(C, K.P, K.R, K.S);
}

}  // namespace
