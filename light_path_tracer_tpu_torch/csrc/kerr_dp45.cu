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
// The disk variant (kDisk, entry lpt_kerr_dp45_disk) replaces the same
// Pallas kernel with its disk_plane recorder (trace_disk_rays_pallas):
// after each accepted step it locates a crossing of cos(theta) = plane_c
// on the step's interpolant and keeps the first kMaxHits in-disk
// crossings in registers (5 to 17 more live floats; 72-92 registers and
// no spills on sm_90a against the shadow variant's 71). Its frame time is
// set by the slowest ray's serial chain of attempts: a ray just off the
// polar axis can spend the whole max_steps budget at ~3 us an attempt,
// and the two-pass drivers cannot shorten that chain.
//
// Numerics follow the float32 path of the JAX package's dp45_integrate:
// the tableau is the double coefficients rounded to float, stage sums are
// taken as c0 k0 + c1 k1 + ... and then multiplied by h, and the max/min/
// clip helpers propagate NaN as jnp.maximum/minimum/clip do. Build without
// --use_fast_math: the approximate __sinf/__cosf lose accuracy once |theta|
// or |phi| grows (over-the-pole rays in the double-cover chart). nvcc
// contracts a*b + c into FMA by default, so results are close to, not
// bitwise equal to, the plain version's.

#include "kerr_dp45_common.cuh"

namespace {

// Disk-plane settings of the disk variant: the annulus r_in <= r <= r_out
// of the plane cos(theta) = plane_c, and whether it stops rays.
struct DiskParams {
  float r_in, r_out, plane_c;
  int opaque;
};

// What one DP45 attempt produced.
struct Attempt {
  float k7[5];     // FSAL stage, the derivative at y5
  float y_acc[5];  // state if accepted: y5, or the event point
  float h_eff, frac, h_new;
  bool accept, cap, esc, underflow;
};

// One adaptive DP45 attempt from (y, k1) with step h: the six new stages,
// the embedded error norm, capture/escape located on the step's cubic
// Hermite interpolant, and the step-size control (one pow serves both
// shrink and grow). Shared by the shadow and disk variants; the caller
// applies the result.
__device__ __forceinline__ void dp45_attempt(
    const float y[5], const float k1[5], float h, float lam, float lam_max,
    float p_t, float p_phi, float atol, float rtol, float r_capture,
    float r_escape, float r_plunge, const Params& P, Attempt& A) {
  const float h_eff = jmax(jmin(h, lam_max - lam), 0.0f);

  float yt[5], k2[5], k3[5], k4[5], k5[5], k6[5], y5[5];
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
  float* k7 = A.k7;
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
#pragma unroll
  for (int c = 0; c < 5; ++c) A.y_acc[c] = y5[c];
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
      A.y_acc[c] = h00 * y[c] + h10 * h_eff * k1[c] + h01 * y5[c] +
                   h11 * h_eff * k7[c];
  }

  const float factor = 0.9f * powf(jmax(err_norm, 1e-30f), -0.2f);
  const float shrink = jmax(0.2f, factor);
  const float grow = err_norm < P.tiny_err ? 5.0f : jmin(5.0f, factor);
  const float h_new =
      accept ? h * grow : (reject ? h * shrink : (blowup ? h * 0.25f : h));

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
// p_r and p_theta when kMomentum) in registers.
template <bool kDisk, int kMaxHits, bool kMomentum>
__global__ void __launch_bounds__(kThreads)
kerr_dp45_kernel(const float* __restrict__ alpha,
                 const float* __restrict__ theta,
                 const unsigned char* __restrict__ refine,
                 float* __restrict__ r_out, float* __restrict__ th_out,
                 float* __restrict__ phi_out, float* __restrict__ pr_out,
                 float* __restrict__ pth_out, int* __restrict__ status_out,
                 int* __restrict__ steps_out, int* __restrict__ hits_out,
                 float* __restrict__ r_hits_out,
                 float* __restrict__ phi_hits_out,
                 float* __restrict__ pr_hits_out,
                 float* __restrict__ pth_hits_out, int n, Params P,
                 DiskParams D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float M = P.M, a = P.a;
  const float al = alpha[i];
  const float scr = theta[i];
  float atol = P.atol, rtol = P.rtol;
  if constexpr (!kDisk) {
    const bool ref = refine[i] != 0;
    atol = ref ? P.atol_ref : P.atol;
    rtol = ref ? P.rtol_ref : P.rtol;
  }

  // ---- Bardeen initial conditions (models/kerr.py initial_conditions_5d)
  const RayStart S = initial_state(al, scr, P);
  const float p_t = S.p_t, p_phi = S.p_phi;

  // ---- certain-plunge radius (models/kerr.py plunge_radii); radius 0,
  // which no accepted step reaches, disables the exit in disk mode
  float r_plunge = 0.0f;
  if constexpr (!kDisk) {
    const float rho_p = P.r_obs * S.sin_al * sqrtf(S.Sigma) /
                        sqrtf(jmax(S.Delta, 1e-30f));
    const float as_p = -rho_p * S.sin_scr;
    const float bs_p = -rho_p * S.cos_scr;
    const float eta_p =
        bs_p * bs_p + S.cos_th * S.cos_th * (as_p * as_p - a * a);
    const float ratio = jclip(-a / jmax(M, 1e-30f), -1.0f, 1.0f);
    const float r_pro =
        2.0f * M * (1.0f + cosf((float)(2.0 / 3.0) * acosf(ratio)));
    r_plunge = eta_p >= 0.0f ? 0.999f * r_pro : 0.0f;
  }

  const float r_capture = P.r_capture;
  const float r_escape = P.r_obs * 2.0f;
  const float lam_max = P.lambda_max;

  // ---- adaptive DP45 + FSAL loop (ops/kerr_trace.py dp45_integrate)
  float y[5] = {S.y[0], S.y[1], S.y[2], S.y[3], S.y[4]};
  float k1[5];
  rhs5(y, p_t, p_phi, P, k1);
  float h = P.h_init;
  float lam = 0.0f;
  int status = S.bad_obs ? kInvalid : kRunning;
  int steps = 0;

  // crossing records (disk variant); sized 1 when unused
  constexpr int kSlots = kDisk ? kMaxHits : 1;
  constexpr int kMomSlots = kMomentum ? kMaxHits : 1;
  int n_hits = 0;
  float r_hits[kSlots], phi_hits[kSlots], pr_hits[kMomSlots],
      pth_hits[kMomSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) r_hits[s] = phi_hits[s] = 0.0f;
#pragma unroll
  for (int s = 0; s < kMomSlots; ++s) pr_hits[s] = pth_hits[s] = 0.0f;

  while (steps < P.max_steps && status == kRunning && lam < lam_max) {
    ++steps;
    Attempt A;
    dp45_attempt(y, k1, h, lam, lam_max, p_t, p_phi, atol, rtol, r_capture,
                 r_escape, r_plunge, P, A);
    const bool event = A.cap || A.esc;

    // disk plane: a sign change of cos(theta) - plane_c over the accepted
    // segment [y, y_acc], or landing on the plane, located at the linear
    // root of that difference on the step's Hermite interpolant (linear
    // interpolation when an event shortened the step: k7 belongs to y5)
    bool park = false;
    float yc[5];
    if constexpr (kDisk) {
      if (A.accept) {
        const float d_prev = cosf(y[1]) - D.plane_c;
        const float d_next = cosf(A.y_acc[1]) - D.plane_c;
        if ((d_prev * d_next < 0.0f) || (d_next == 0.0f && d_prev != 0.0f)) {
          const float den = d_next == d_prev ? 1.0f : d_next - d_prev;
          const float s = jclip(-d_prev / den, 0.0f, 1.0f);
          if (event) {
#pragma unroll
            for (int c = 0; c < 5; ++c)
              yc[c] = y[c] + s * (A.y_acc[c] - y[c]);
          } else {
            const float hs = A.frac * A.h_eff;
            const float s2 = s * s, s3 = s2 * s;
            const float h00 = 2.0f * s3 - 3.0f * s2 + 1.0f;
            const float h10 = s3 - 2.0f * s2 + s;
            const float h01 = -2.0f * s3 + 3.0f * s2;
            const float h11 = s3 - s2;
#pragma unroll
            for (int c = 0; c < 5; ++c)
              yc[c] = h00 * y[c] + h10 * hs * k1[c] + h01 * A.y_acc[c] +
                      h11 * hs * A.k7[c];
          }
          if (yc[0] >= D.r_in && yc[0] <= D.r_out) {
            // physical azimuth: phi + pi on the sin(theta) < 0 branch
            const float phi_c = sinf(yc[1]) < 0.0f ? yc[2] + kPi : yc[2];
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
          }
        }
      }
    }

    if (A.accept) {
      const bool corrupt = !all_finite(A.y_acc);
      lam = lam + A.frac * A.h_eff;
#pragma unroll
      for (int c = 0; c < 5; ++c) y[c] = A.y_acc[c];
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
  }

  r_out[i] = y[0];
  th_out[i] = y[1];
  phi_out[i] = y[2];
  pr_out[i] = y[3];
  pth_out[i] = y[4];
  status_out[i] = status;
  steps_out[i] = steps;
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
void launch_disk(int blocks, cudaStream_t stream, const float* alpha,
                 const float* theta, float* const state[5], int* status,
                 int* steps, int* hits, float* const rec[4], int n,
                 const Params& P, const DiskParams& D) {
  kerr_dp45_kernel<true, kMaxHits, kMomentum>
      <<<blocks, kThreads, 0, stream>>>(
          alpha, theta, nullptr, state[0], state[1], state[2], state[3],
          state[4], status, steps, hits, rec[0], rec[1], rec[2], rec[3], n,
          P, D);
}

}  // namespace

extern "C" {

// Launches the shadow variant on `stream` and returns cudaGetLastError()
// (0 on success). Pointers are device pointers; refine is one byte per ray.
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
  kerr_dp45_kernel<false, 1, false>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(alpha), static_cast<const float*>(theta),
          static_cast<const unsigned char*>(refine),
          static_cast<float*>(r_out), static_cast<float*>(th_out),
          static_cast<float*>(phi_out), static_cast<float*>(pr_out),
          static_cast<float*>(pth_out), static_cast<int*>(status_out),
          static_cast<int*>(steps_out), nullptr, nullptr, nullptr, nullptr,
          nullptr, n, P, DiskParams{0.0f, 0.0f, 0.0f, 0});
  return static_cast<int>(cudaGetLastError());
}

// Launches the disk variant. hits_out: int32 per ray; r_hits_out,
// phi_hits_out (and pr_hits_out, pth_hits_out when momentum != 0, else
// unused): (max_hits, n) float32, slot-major. max_hits is 1..4.
int lpt_kerr_dp45_disk(const void* alpha, const void* theta, void* r_out,
                       void* th_out, void* phi_out, void* pr_out,
                       void* pth_out, void* status_out, void* steps_out,
                       void* hits_out, void* r_hits_out, void* phi_hits_out,
                       void* pr_hits_out, void* pth_hits_out, int n,
                       int max_hits, int momentum, float M, float a,
                       float r_plus, float r_obs, float theta_obs,
                       float lambda_max, int max_steps, float atol,
                       float rtol, float h_min, float tiny_err, float h_init,
                       float r_capture, float r_in, float r_out_disk,
                       float plane_c, int opaque, void* stream) {
  if (n <= 0) return 0;
  Params P{M,    a,     r_plus, r_obs, theta_obs, lambda_max,
           max_steps, atol, rtol, atol, rtol,      h_min,
           tiny_err, h_init, r_capture};
  const DiskParams D{r_in, r_out_disk, plane_c, opaque};
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(alpha);
  const float* th = static_cast<const float*>(theta);
  float* const state[5] = {
      static_cast<float*>(r_out), static_cast<float*>(th_out),
      static_cast<float*>(phi_out), static_cast<float*>(pr_out),
      static_cast<float*>(pth_out)};
  float* const rec[4] = {
      static_cast<float*>(r_hits_out), static_cast<float*>(phi_hits_out),
      static_cast<float*>(pr_hits_out), static_cast<float*>(pth_hits_out)};
  int* st = static_cast<int*>(status_out);
  int* sp = static_cast<int*>(steps_out);
  int* hi = static_cast<int*>(hits_out);
  switch (max_hits * 2 + (momentum != 0)) {
    case 2: launch_disk<1, false>(blocks, s, al, th, state, st, sp, hi, rec, n, P, D); break;
    case 3: launch_disk<1, true>(blocks, s, al, th, state, st, sp, hi, rec, n, P, D); break;
    case 4: launch_disk<2, false>(blocks, s, al, th, state, st, sp, hi, rec, n, P, D); break;
    case 5: launch_disk<2, true>(blocks, s, al, th, state, st, sp, hi, rec, n, P, D); break;
    case 6: launch_disk<3, false>(blocks, s, al, th, state, st, sp, hi, rec, n, P, D); break;
    case 7: launch_disk<3, true>(blocks, s, al, th, state, st, sp, hi, rec, n, P, D); break;
    case 8: launch_disk<4, false>(blocks, s, al, th, state, st, sp, hi, rec, n, P, D); break;
    case 9: launch_disk<4, true>(blocks, s, al, th, state, st, sp, hi, rec, n, P, D); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
