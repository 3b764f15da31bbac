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
// out; twice that in float64). The state lives in registers for the whole
// loop. The cost that matters is warp divergence: a warp runs until its
// slowest lane is done, and ray lifetimes range from tens of attempts to
// the full budget. The raster order of an image grid keeps neighbouring
// rays similar in difficulty, so consecutive rays share a warp.
//
// A lane whose state freezes bitwise in an exact cycle of (h, lambda)
// (kerr_dp45_common.cuh, CycleWatch) would repeat that cycle until
// max_steps; the loop counts those attempts at once instead (cycle_exit =
// 1; 0 grinds them, for the bitwise check), which gives the same outputs.
// A ray just off the polar axis of the config-4 disk grid grinds so on the
// card: this loop has no frozen-state window.
//
// The disk variant (kDisk, entry lpt_kerr_dp45_disk) replaces the same
// Pallas kernel with its disk_plane recorder (trace_disk_rays_pallas):
// after each accepted step it locates a crossing of cos(theta) = plane_c
// on the step's interpolant and keeps the first kMaxHits in-disk
// crossings in registers (5 to 17 more live values). A frozen state
// cannot cross the plane, so the cycle exit leaves the hit record alone.
//
// Numerics follow the JAX package's dp45_integrate in the scalar type of
// the instance (kerr_dp45_common.cuh): this file builds the float
// instances, kerr_dp45_f64.cu the double ones (entries *_f64). Build
// without --use_fast_math: the approximate __sinf/__cosf lose accuracy
// once |theta| or |phi| grows (over-the-pole rays in the double-cover
// chart). nvcc contracts a*b + c into FMA by default, so results are close
// to, not bitwise equal to, the plain version's.

#include "kerr_dp45_common.cuh"

namespace {

// Disk-plane settings of the disk variant: the annulus r_in <= r <= r_out
// of the plane cos(theta) = plane_c, and whether it stops rays.
template <class T>
struct DiskParams {
  T r_in, r_out, plane_c;
  int opaque;
};

// What one DP45 attempt produced.
template <class T>
struct Attempt {
  T k7[5];     // FSAL stage, the derivative at y5
  T y_acc[5];  // state if accepted: y5, or the event point
  T h_eff, frac, h_new;
  bool accept, cap, esc, underflow;
};

// One adaptive DP45 attempt from (y, k1) with step h: the six new stages,
// the embedded error norm, capture/escape located on the step's cubic
// Hermite interpolant, and the step-size control (one pow serves both
// shrink and grow). Shared by the shadow and disk variants; the caller
// applies the result.
template <class T>
__device__ __forceinline__ void dp45_attempt(
    const T y[5], const T k1[5], T h, T lam, T lam_max, T p_t, T p_phi,
    T atol, T rtol, T r_capture, T r_escape, T r_plunge, const Params<T>& P,
    Attempt<T>& A) {
  using K = Tab<T>;
  const T h_eff = jmax(jmin(h, lam_max - lam), T(0.0));

  T yt[5], k2[5], k3[5], k4[5], k5[5], k6[5], y5[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) yt[c] = y[c] + h_eff * (K::A21 * k1[c]);
  rhs5(yt, p_t, p_phi, P, k2);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    yt[c] = y[c] + h_eff * (K::A31 * k1[c] + K::A32 * k2[c]);
  rhs5(yt, p_t, p_phi, P, k3);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    yt[c] = y[c] + h_eff * (K::A41 * k1[c] + K::A42 * k2[c] +
                            K::A43 * k3[c]);
  rhs5(yt, p_t, p_phi, P, k4);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    yt[c] = y[c] + h_eff * (K::A51 * k1[c] + K::A52 * k2[c] +
                            K::A53 * k3[c] + K::A54 * k4[c]);
  rhs5(yt, p_t, p_phi, P, k5);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    yt[c] = y[c] + h_eff * (K::A61 * k1[c] + K::A62 * k2[c] +
                            K::A63 * k3[c] + K::A64 * k4[c] +
                            K::A65 * k5[c]);
  rhs5(yt, p_t, p_phi, P, k6);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    y5[c] = y[c] + h_eff * (K::B1 * k1[c] + K::B3 * k3[c] + K::B4 * k4[c] +
                            K::B5 * k5[c] + K::B6 * k6[c]);
  T* k7 = A.k7;
  rhs5(y5, p_t, p_phi, P, k7);

  const bool finite_ok = all_finite(y5) && (y5[0] > T(0.0));

  // error scale (increment-aware in float32) and embedded error norm
  T err_sq = T(0.0);
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const T scale = error_scale(y[c], y5[c], k1[c], k7[c], h_eff, atol,
                                rtol);
    const T err = h_eff * (K::E1 * k1[c] + K::E3 * k3[c] + K::E4 * k4[c] +
                           K::E5 * k5[c] + K::E6 * k6[c] + K::E7 * k7[c]);
    const T q = finite_ok ? err / scale : T(0.0);
    err_sq = err_sq + q * q;
  }
  const T err_norm = sqrt_(err_sq / T(5.0));

  const bool accept = finite_ok && (err_norm <= T(1.0));
  const bool reject = finite_ok && (err_norm > T(1.0));
  const bool blowup = !finite_ok;

  // events on accepted steps (capture has priority over escape)
  const T r_prev = y[0], r_next = y5[0];
  const bool cap = accept && ((r_prev > r_capture && r_next <= r_capture) ||
                              (r_next <= r_plunge && r_next < r_prev));
  const bool esc =
      accept && r_prev < r_escape && r_next >= r_escape && !cap;
  const bool event = cap || esc;

  T frac = T(1.0);
#pragma unroll
  for (int c = 0; c < 5; ++c) A.y_acc[c] = y5[c];
  if (event) {
    const T denom = r_next - r_prev;
    const T target = cap ? r_capture : r_escape;
    const T frac_lin = denom == T(0.0)
                           ? T(1.0)
                           : jclip((target - r_prev) / denom, T(0.0), T(1.0));
    frac = hermite_crossing_frac(r_prev, r_next, k1[0], k7[0], h_eff, target,
                                 frac_lin);
    const T s2 = frac * frac, s3 = s2 * frac;
    const T h00 = T(2.0) * s3 - T(3.0) * s2 + T(1.0);
    const T h10 = s3 - T(2.0) * s2 + frac;
    const T h01 = -T(2.0) * s3 + T(3.0) * s2;
    const T h11 = s3 - s2;
#pragma unroll
    for (int c = 0; c < 5; ++c)
      A.y_acc[c] = h00 * y[c] + h10 * h_eff * k1[c] + h01 * y5[c] +
                   h11 * h_eff * k7[c];
  }

  const T factor = T(0.9) * pow_(jmax(err_norm, T(1e-30)), T(-0.2));
  const T shrink = jmax(T(0.2), factor);
  const T grow = err_norm < P.tiny_err ? T(5.0) : jmin(T(5.0), factor);
  const T h_new = accept ? h * grow
                         : (reject ? h * shrink : (blowup ? h * T(0.25) : h));

  A.h_eff = h_eff;
  A.frac = frac;
  A.h_new = h_new;
  A.accept = accept;
  A.cap = cap;
  A.esc = esc;
  A.underflow = (reject || blowup) && (h_new < P.h_min);
}

// The ray kernel. kDisk = false is the shadow variant (the per-ray
// axis-refine tolerances, the certain-plunge exit). kDisk = true adds the
// plane-crossing recorder of the JAX package's disk mode and drops both:
// base tolerances everywhere and no plunge exit. It keeps the first
// kMaxHits in-disk crossings per ray (radius and physical azimuth, plus
// p_r and p_theta when kMomentum) in registers. census_out (may be null)
// receives CycleWatch::census() per ray.
template <class T, bool kDisk, int kMaxHits, bool kMomentum>
__global__ void __launch_bounds__(kThreads)
kerr_dp45_kernel(const T* __restrict__ alpha, const T* __restrict__ theta,
                 const unsigned char* __restrict__ refine,
                 T* __restrict__ r_out, T* __restrict__ th_out,
                 T* __restrict__ phi_out, T* __restrict__ pr_out,
                 T* __restrict__ pth_out, int* __restrict__ status_out,
                 int* __restrict__ steps_out, int* __restrict__ hits_out,
                 T* __restrict__ r_hits_out, T* __restrict__ phi_hits_out,
                 T* __restrict__ pr_hits_out, T* __restrict__ pth_hits_out,
                 int* __restrict__ census_out, int n, int cycle_exit,
                 Params<T> P, DiskParams<T> D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const T M = P.M, a = P.a;
  const T al = alpha[i];
  const T scr = theta[i];
  T atol = P.atol, rtol = P.rtol;
  if constexpr (!kDisk) {
    const bool ref = refine[i] != 0;
    atol = ref ? P.atol_ref : P.atol;
    rtol = ref ? P.rtol_ref : P.rtol;
  }

  // ---- Bardeen initial conditions (models/kerr.py initial_conditions_5d)
  const RayStart<T> S = initial_state(al, scr, P);
  const T p_t = S.p_t, p_phi = S.p_phi;

  // ---- certain-plunge radius (models/kerr.py plunge_radii); radius 0,
  // which no accepted step reaches, disables the exit in disk mode
  T r_plunge = T(0.0);
  if constexpr (!kDisk) {
    const T rho_p = P.r_obs * S.sin_al * sqrt_(S.Sigma) /
                    sqrt_(jmax(S.Delta, T(1e-30)));
    const T as_p = -rho_p * S.sin_scr;
    const T bs_p = -rho_p * S.cos_scr;
    const T eta_p =
        bs_p * bs_p + S.cos_th * S.cos_th * (as_p * as_p - a * a);
    const T ratio = jclip(-a / jmax(M, T(1e-30)), -T(1.0), T(1.0));
    const T r_pro =
        T(2.0) * M * (T(1.0) + cos_(T(2.0 / 3.0) * acos_(ratio)));
    r_plunge = eta_p >= T(0.0) ? T(0.999) * r_pro : T(0.0);
  }

  const T r_capture = P.r_capture;
  const T r_escape = P.r_obs * T(2.0);
  const T lam_max = P.lambda_max;

  // ---- adaptive DP45 + FSAL loop (ops/kerr_trace.py dp45_integrate)
  T y[5] = {S.y[0], S.y[1], S.y[2], S.y[3], S.y[4]};
  T k1[5];
  rhs5(y, p_t, p_phi, P, k1);
  T h = P.h_init;
  T lam = T(0.0);
  int status = S.bad_obs ? kInvalid : kRunning;
  int steps = 0;
  CycleWatch<T> watch;

  // crossing records (disk variant); sized 1 when unused
  constexpr int kSlots = kDisk ? kMaxHits : 1;
  constexpr int kMomSlots = kMomentum ? kMaxHits : 1;
  int n_hits = 0;
  T r_hits[kSlots], phi_hits[kSlots], pr_hits[kMomSlots],
      pth_hits[kMomSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) r_hits[s] = phi_hits[s] = T(0.0);
#pragma unroll
  for (int s = 0; s < kMomSlots; ++s) pr_hits[s] = pth_hits[s] = T(0.0);

  while (steps < P.max_steps && status == kRunning && lam < lam_max) {
    ++steps;
    Attempt<T> A;
    dp45_attempt(y, k1, h, lam, lam_max, p_t, p_phi, atol, rtol, r_capture,
                 r_escape, r_plunge, P, A);
    const bool event = A.cap || A.esc;

    // disk plane: a sign change of cos(theta) - plane_c over the accepted
    // segment [y, y_acc], or landing on the plane, located at the linear
    // root of that difference on the step's Hermite interpolant (linear
    // interpolation when an event shortened the step: k7 belongs to y5)
    bool park = false, recorded = false;
    T yc[5];
    if constexpr (kDisk) {
      if (A.accept) {
        const T d_prev = cos_(y[1]) - D.plane_c;
        const T d_next = cos_(A.y_acc[1]) - D.plane_c;
        if ((d_prev * d_next < T(0.0)) ||
            (d_next == T(0.0) && d_prev != T(0.0))) {
          const T den = d_next == d_prev ? T(1.0) : d_next - d_prev;
          const T s = jclip(-d_prev / den, T(0.0), T(1.0));
          if (event) {
#pragma unroll
            for (int c = 0; c < 5; ++c)
              yc[c] = y[c] + s * (A.y_acc[c] - y[c]);
          } else {
            const T hs = A.frac * A.h_eff;
            const T s2 = s * s, s3 = s2 * s;
            const T h00 = T(2.0) * s3 - T(3.0) * s2 + T(1.0);
            const T h10 = s3 - T(2.0) * s2 + s;
            const T h01 = -T(2.0) * s3 + T(3.0) * s2;
            const T h11 = s3 - s2;
#pragma unroll
            for (int c = 0; c < 5; ++c)
              yc[c] = h00 * y[c] + h10 * hs * k1[c] + h01 * A.y_acc[c] +
                      h11 * hs * A.k7[c];
          }
          if (yc[0] >= D.r_in && yc[0] <= D.r_out) {
            // physical azimuth: phi + pi on the sin(theta) < 0 branch
            const T phi_c =
                sin_(yc[1]) < T(0.0) ? yc[2] + Consts<T>::kPi : yc[2];
#pragma unroll
            for (int slot = 0; slot < kSlots; ++slot) {
              if (n_hits == slot) {
                r_hits[slot] = yc[0];
                phi_hits[slot] = phi_c;
                if constexpr (kMomentum) {
                  pr_hits[slot] = yc[3];
                  pth_hits[slot] = yc[4];
                }
              }
            }
            n_hits = n_hits + 1 < kSlots ? n_hits + 1 : kSlots;
            park = D.opaque != 0 && n_hits == 1;
            recorded = true;
          }
        }
      }
    }

    bool moved = false;
    if (A.accept) {
      const bool corrupt = !all_finite(A.y_acc);
      lam = lam + A.frac * A.h_eff;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        moved = moved || !same_bits(A.y_acc[c], y[c]);
        y[c] = A.y_acc[c];
      }
      // FSAL: stage 7 seeds the next step's stage 1, except after events.
      if (!event) {
#pragma unroll
        for (int c = 0; c < 5; ++c) k1[c] = A.k7[c];
      }
      if (A.cap) status = kCaptured;
      else if (A.esc) status = kEscaped;
      if (corrupt) status = kInvalid;
    }
    if (A.underflow) status = kInvalid;
    if constexpr (kDisk) {
      // an opaque disk parks a still-running ray at its first in-disk
      // crossing; a ray captured in the same step stays captured
      if (park && status == kRunning) {
#pragma unroll
        for (int c = 0; c < 5; ++c) y[c] = yc[c];
        status = kEscaped;
      }
    }
    h = A.h_new;

    // An exact cycle of a frozen lane runs to the step budget: count it.
    const bool running = status == kRunning && lam < lam_max;
    if (watch.update(!moved && !recorded, A.accept && !event, h, lam,
                     running) &&
        cycle_exit)
      steps = P.max_steps;
  }

  r_out[i] = y[0];
  th_out[i] = y[1];
  phi_out[i] = y[2];
  pr_out[i] = y[3];
  pth_out[i] = y[4];
  status_out[i] = status;
  steps_out[i] = steps;
  if (census_out != nullptr) census_out[i] = watch.census();
  if constexpr (kDisk) {
    hits_out[i] = n_hits;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const size_t k = static_cast<size_t>(s) * n + i;
      r_hits_out[k] = r_hits[s];
      phi_hits_out[k] = phi_hits[s];
      if constexpr (kMomentum) {
        pr_hits_out[k] = pr_hits[s];
        pth_hits_out[k] = pth_hits[s];
      }
    }
  }
}

template <int kMaxHits, bool kMomentum>
void launch_disk(int blocks, cudaStream_t stream, const Real* alpha,
                 const Real* theta, Real* const state[5], int* status,
                 int* steps, int* hits, Real* const rec[4], int* census,
                 int n, int cycle_exit, const Params<Real>& P,
                 const DiskParams<Real>& D) {
  kerr_dp45_kernel<Real, true, kMaxHits, kMomentum>
      <<<blocks, kThreads, 0, stream>>>(
          alpha, theta, nullptr, state[0], state[1], state[2], state[3],
          state[4], status, steps, hits, rec[0], rec[1], rec[2], rec[3],
          census, n, cycle_exit, P, D);
}

}  // namespace

extern "C" {

// Launches the shadow variant on `stream` and returns cudaGetLastError()
// (0 on success). Pointers are device pointers to Real (float here, double
// in the *_f64 entry); refine is one byte per ray; census_out may be null.
// cycle_exit = 0 grinds exact cycles instead of counting them.
int LPT_ENTRY(lpt_kerr_dp45)(
    const void* alpha, const void* theta, const void* refine, void* r_out,
    void* th_out, void* phi_out, void* pr_out, void* pth_out,
    void* status_out, void* steps_out, void* census_out, int n,
    int cycle_exit, Real M, Real a, Real r_plus, Real r_obs, Real theta_obs,
    Real lambda_max, int max_steps, Real atol, Real rtol, Real atol_ref,
    Real rtol_ref, Real h_min, Real tiny_err, Real h_init, Real r_capture,
    void* stream) {
  if (n <= 0) return 0;
  Params<Real> P{M,    a,     r_plus,   r_obs,    theta_obs, lambda_max,
                 max_steps, atol, rtol, atol_ref, rtol_ref,  h_min,
                 tiny_err, h_init, r_capture};
  const int blocks = (n + kThreads - 1) / kThreads;
  kerr_dp45_kernel<Real, false, 1, false>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const Real*>(alpha), static_cast<const Real*>(theta),
          static_cast<const unsigned char*>(refine),
          static_cast<Real*>(r_out), static_cast<Real*>(th_out),
          static_cast<Real*>(phi_out), static_cast<Real*>(pr_out),
          static_cast<Real*>(pth_out), static_cast<int*>(status_out),
          static_cast<int*>(steps_out), nullptr, nullptr, nullptr, nullptr,
          nullptr, static_cast<int*>(census_out), n, cycle_exit, P,
          DiskParams<Real>{Real(0.0), Real(0.0), Real(0.0), 0});
  return static_cast<int>(cudaGetLastError());
}

// Launches the disk variant. hits_out: int32 per ray; r_hits_out,
// phi_hits_out (and pr_hits_out, pth_hits_out when momentum != 0, else
// unused): (max_hits, n) Real, slot-major. max_hits is 1..4.
int LPT_ENTRY(lpt_kerr_dp45_disk)(
    const void* alpha, const void* theta, void* r_out, void* th_out,
    void* phi_out, void* pr_out, void* pth_out, void* status_out,
    void* steps_out, void* hits_out, void* r_hits_out, void* phi_hits_out,
    void* pr_hits_out, void* pth_hits_out, void* census_out, int n,
    int max_hits, int momentum, int cycle_exit, Real M, Real a, Real r_plus,
    Real r_obs, Real theta_obs, Real lambda_max, int max_steps, Real atol,
    Real rtol, Real h_min, Real tiny_err, Real h_init, Real r_capture,
    Real r_in, Real r_out_disk, Real plane_c, int opaque, void* stream) {
  if (n <= 0) return 0;
  Params<Real> P{M,    a,     r_plus, r_obs, theta_obs, lambda_max,
                 max_steps, atol, rtol, atol, rtol,      h_min,
                 tiny_err, h_init, r_capture};
  const DiskParams<Real> D{r_in, r_out_disk, plane_c, opaque};
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Real* al = static_cast<const Real*>(alpha);
  const Real* th = static_cast<const Real*>(theta);
  Real* const state[5] = {
      static_cast<Real*>(r_out), static_cast<Real*>(th_out),
      static_cast<Real*>(phi_out), static_cast<Real*>(pr_out),
      static_cast<Real*>(pth_out)};
  Real* const rec[4] = {
      static_cast<Real*>(r_hits_out), static_cast<Real*>(phi_hits_out),
      static_cast<Real*>(pr_hits_out), static_cast<Real*>(pth_hits_out)};
  int* st = static_cast<int*>(status_out);
  int* sp = static_cast<int*>(steps_out);
  int* hi = static_cast<int*>(hits_out);
  int* ce = static_cast<int*>(census_out);
  const int x = cycle_exit;
  switch (max_hits * 2 + (momentum != 0)) {
    case 2: launch_disk<1, false>(blocks, s, al, th, state, st, sp, hi, rec, ce, n, x, P, D); break;
    case 3: launch_disk<1, true>(blocks, s, al, th, state, st, sp, hi, rec, ce, n, x, P, D); break;
    case 4: launch_disk<2, false>(blocks, s, al, th, state, st, sp, hi, rec, ce, n, x, P, D); break;
    case 5: launch_disk<2, true>(blocks, s, al, th, state, st, sp, hi, rec, ce, n, x, P, D); break;
    case 6: launch_disk<3, false>(blocks, s, al, th, state, st, sp, hi, rec, ce, n, x, P, D); break;
    case 7: launch_disk<3, true>(blocks, s, al, th, state, st, sp, hi, rec, ce, n, x, P, D); break;
    case 8: launch_disk<4, false>(blocks, s, al, th, state, st, sp, hi, rec, ce, n, x, P, D); break;
    case 9: launch_disk<4, true>(blocks, s, al, th, state, st, sp, hi, rec, ce, n, x, P, D); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifndef LPT_DOUBLE
const char* lpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif

}  // extern "C"
