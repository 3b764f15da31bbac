// The surface ray kernel for Hopper (sm_90a): rays traced onto an opaque
// sphere r = r_surface, their raw end state kept.
//
// Replaces no Pallas kernel: it is the CUDA form of the JAX package's XLA
// loop light_path_tracer_tpu/ops/kerr_trace.py::trace_rays_surface (:536),
// the primitive of the lens-map products (pipeline._trace_escape_beta,
// images.find_point_images) and of star.py. The plain PyTorch version is
// light_path_tracer_tpu_torch/ops/kerr_trace.py trace_rays_surface; the
// wrapper is ops/cuda/surface_kernel.py.
//
// One thread runs one ray, in index order, 128 threads a block: the Bardeen
// initial conditions, the adaptive loop (DP45 + FSAL here, Hairer's DOP853
// where the source defines LPT_DOP853) over the N = 5 geodesic components,
// or N = 6 with the coordinate time (kTime: dt/dlambda = g^tt p_t +
// g^tphi p_phi, the metric's tdot, under the same error control), until
// the ray crosses the surface inward (r_capture = r_surface, CAPTURED),
// crosses r = 2 r_obs outward (ESCAPED), goes invalid, spends max_steps
// attempts or reaches lambda_max; both events are located on the step's
// cubic Hermite interpolant, every component shortened to the event point.
// The loop is the shared one of ops/kerr_trace.py dp45_integrate with base
// tolerances on every ray and no certain-plunge exit, which the Kerr
// kernel's shadow instances (kerr_dp45.cu) take: there a plunging ray ends
// inside the photon-orbit band, not on the surface. Then the angle
// extraction of a finished ray (finalize, kerr_dp45_common.cuh, with
// r_reclass = 1.1 x the metric's capture radius), and the outputs: the raw
// end state (5, n), xi = p_phi / max(-p_t, 1e-30), t (kTime) and the
// extraction's final_alpha, n_half and status. A lane frozen in an exact
// cycle is counted out at once (CycleWatch), which changes no output.
//
// Families: Kerr, Kerr-Newman and Johannsen-Psaltis (SurfaceCall::family,
// a template argument of each instance), each with and without the time
// component. Numerics are kerr_dp45_common.cuh's: built with -fmad=false,
// every product and sum rounds apart as in the plain loop; the float64
// instances raise through lpt_pow_f64 (relocatable device code), as
// PyTorch's float64 pow does on the card.
//
// What bounds it: arithmetic and the slowest ray, as the Kerr kernel (a ray
// moves about 9 bytes in and 37 out in float32; its attempts make 6 RHS
// evaluations, 12 under DOP853, each with a sinf and a cosf).

#pragma once

#include "kerr_dp45_common.cuh"
#include "kerr_dop853.cuh"

namespace {

// One call of the C entry point, filled by the Python wrapper
// (ops/cuda/surface_kernel.py SurfaceCall and SurfaceCall64, field for
// field): device pointers, the stream, the ints, then the scalars of T.
// state is (5, n); t_hit (n) is written when record_time (may be null
// otherwise); steps (may be null) receives the per-ray attempts;
// warp_steps is one int64, zeroed by the entry.
template <class T>
struct SurfaceCall {
  const T *alpha, *theta;
  T* final_alpha;
  int *n_half, *status;
  T *state, *t_hit, *xi;
  int* steps;
  unsigned long long* warp_steps;
  void* stream;
  int n, max_steps, family, record_time;
  T M, a, r_plus, r_obs, theta_obs, lambda_max, atol, rtol, h_min,
      tiny_err, h_init, r_capture, r_reclass, q2, eps3, r_freeze;
};

static_assert(sizeof(SurfaceCall<float>) == 168, "SurfaceCall layout");
static_assert(sizeof(SurfaceCall<double>) == 232, "SurfaceCall64 layout");

// dt/dlambda = g^tt p_t + g^tphi p_phi at (r, theta) with s, c its sine
// and cosine (models/kerr.py tdot through the family's _inv_terms, term
// for term).
template <int F, class T>
__device__ __forceinline__ T tdot(T r, T s, T c, T p_t, T p_phi,
                                  const Params<T>& P) {
  if constexpr (F == kJohannsenPsaltis) {
    const InverseMetric<T> G = inverse_metric_jp(r, s, c, P);
    return G.tt * p_t + G.tphi * p_phi;
  } else {
    const T sin2 = jmax(s * s, Consts<T>::kSin2Floor);
    const T r2 = r * r, a2 = P.a * P.a;
    const T Sigma = r2 + a2 * c * c;
    T Delta = r2 - T(2.0) * P.M * r + a2;
    if constexpr (F == kKerrNewman) Delta = Delta + P.q2;
    const T ra2 = r2 + a2;
    const T A = ra2 * ra2 - a2 * Delta * sin2;
    const T SD = Sigma * Delta;
    if constexpr (F == kKerrNewman)
      return -A / SD * p_t + -P.a * (T(2.0) * P.M * r - P.q2) / SD * p_phi;
    else
      return -A / SD * p_t + -T(2.0) * P.M * P.a * r / SD * p_phi;
  }
}

// The right-hand side over the N components: the geodesic's five, then
// (N = 6) the coordinate time's rate.
template <int F, class T, int N>
__device__ __forceinline__ void surface_rhs(const T (&y)[N], T p_t, T p_phi,
                                            const Params<T>& P,
                                            T (&out)[N]) {
  const T s = sin_(y[1]), c = cos_(y[1]);
  rhs5_trig<F>(y, s, c, p_t, p_phi, P, out);
  if constexpr (N == 6) out[5] = tdot<F>(y[0], s, c, p_t, p_phi, P);
}

// The 128-thread blocks an SM must hold at once (the register cap).
template <class T>
constexpr int kSurfaceBlocks = kSingle<T> ? 6 : 3;

template <class T, int F, bool kTime>
__global__ void __launch_bounds__(kThreads, kSurfaceBlocks<T>)
LPT_KERNEL(surface_kernel)(SurfaceCall<T> C, Params<T> P) {
  using K = Tab<T>;
  constexpr int N = kTime ? 6 : 5;
  const int n = C.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0;

  if (i < n) {
    const RayStart<T> S0 = initial_state<F>(C.alpha[i], C.theta[i], P);
    const T p_t = S0.p_t, p_phi = S0.p_phi;
    const T r_capture = P.r_capture;
    const T r_escape = P.r_obs * T(2.0);
    const T lam_max = P.lambda_max;

    T y[N];
#pragma unroll
    for (int c = 0; c < N; ++c) y[c] = c < 5 ? S0.y[c] : T(0.0);
    T k1[N];
    surface_rhs<F>(y, p_t, p_phi, P, k1);
    T h = P.h_init;
    T lam = T(0.0);
    int status = S0.bad_obs ? kInvalid : kRunning;
    CycleWatch<T> watch;

    while (steps < P.max_steps && status == kRunning && lam < lam_max) {
      ++steps;
      const T h_eff = jmax(jmin(h, lam_max - lam), T(0.0));

#ifdef LPT_DOP853
      T yt[N], y5[N], k7[N];
      bool finite_ok;
      const T err_norm = dop853_stages(
          y, k1, h_eff, P.atol, P.rtol,
          [&](const T(&ys)[N], T(&out)[N]) {
            surface_rhs<F>(ys, p_t, p_phi, P, out);
          },
          y5, k7, finite_ok);
#else
      T yt[N], k2[N], k3[N], k4[N], k5[N], k6[N], y5[N], k7[N];
#pragma unroll
      for (int c = 0; c < N; ++c) yt[c] = y[c] + h_eff * (K::A21 * k1[c]);
      surface_rhs<F>(yt, p_t, p_phi, P, k2);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (K::A31 * k1[c] + K::A32 * k2[c]);
      surface_rhs<F>(yt, p_t, p_phi, P, k3);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (K::A41 * k1[c] + K::A42 * k2[c] +
                                K::A43 * k3[c]);
      surface_rhs<F>(yt, p_t, p_phi, P, k4);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (K::A51 * k1[c] + K::A52 * k2[c] +
                                K::A53 * k3[c] + K::A54 * k4[c]);
      surface_rhs<F>(yt, p_t, p_phi, P, k5);
#pragma unroll
      for (int c = 0; c < N; ++c)
        yt[c] = y[c] + h_eff * (K::A61 * k1[c] + K::A62 * k2[c] +
                                K::A63 * k3[c] + K::A64 * k4[c] +
                                K::A65 * k5[c]);
      surface_rhs<F>(yt, p_t, p_phi, P, k6);
#pragma unroll
      for (int c = 0; c < N; ++c)
        y5[c] = y[c] + h_eff * (K::B1 * k1[c] + K::B3 * k3[c] +
                                K::B4 * k4[c] + K::B5 * k5[c] +
                                K::B6 * k6[c]);
      surface_rhs<F>(y5, p_t, p_phi, P, k7);

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

      // events on accepted steps: the surface (capture) has priority
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

      bool moved = false;
      if (accept) {
#pragma unroll
        for (int c = 0; c < N; ++c)
          moved = moved || !same_bits(y_acc[c], y[c]);
        const bool corrupt = !all_finite(y_acc);
        lam = lam + frac * h_eff;
#pragma unroll
        for (int c = 0; c < N; ++c) y[c] = y_acc[c];
        // FSAL: the end stage seeds the next step's stage 1, except after
        // events.
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

      // An exact cycle of a frozen lane runs to the step budget: count it.
      if (watch.update(!moved, accept && !event, h, lam,
                       status == kRunning && lam < lam_max))
        steps = P.max_steps;
    }

    const Final<T> Fin = finalize<F>(y, p_t, p_phi, status, C.r_reclass, P);
    C.final_alpha[i] = Fin.alpha;
    C.n_half[i] = Fin.n_half;
    C.status[i] = Fin.status;
#pragma unroll
    for (int c = 0; c < 5; ++c) C.state[static_cast<size_t>(c) * n + i] = y[c];
    C.xi[i] = p_phi / jmax(-p_t, T(1e-30));
    if constexpr (kTime) C.t_hit[i] = y[5];
    if (C.steps != nullptr) C.steps[i] = steps;
  }

  // The warp's largest per-ray attempt count (lanes past n count 0).
  const unsigned int warp_max =
      __reduce_max_sync(kFullMask, static_cast<unsigned int>(steps));
  if ((threadIdx.x & 31) == 0 && warp_max != 0)
    atomicAdd(C.warp_steps, static_cast<unsigned long long>(warp_max));
}

template <int F, bool kTime>
int launch_surface(const SurfaceCall<Real>& C, const Params<Real>& P) {
  LPT_KERNEL(surface_kernel)<Real, F, kTime>
      <<<(C.n + kThreads - 1) / kThreads, kThreads, 0,
         static_cast<cudaStream_t>(C.stream)>>>(C, P);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_family(const SurfaceCall<Real>& C, const Params<Real>& P) {
  if (C.record_time) return launch_surface<F, true>(C, P);
  return launch_surface<F, false>(C, P);
}

}  // namespace
