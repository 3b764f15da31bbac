// Kerr adaptive Dormand-Prince 4(5) ray kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py::_trace_tile_kernel
//   (entry trace_rays_kerr_pallas),
// written from what that kernel computes, not from its tiling. The plain
// PyTorch version is light_path_tracer_tpu_torch/ops/kerr_trace.py
// (trace_rays_kerr); the wrapper is ops/cuda/kerr_trace_kernel.py.
//
// Like the Pallas kernel it traces three metric families: Kerr,
// Kerr-Newman and Johannsen-Psaltis (KerrCall::family; a template
// argument of every instance, so each family's loop is compiled alone and
// Kerr's is the code it was before the others existed). Kerr-Newman
// changes a few flops of the RHS and takes its plunge radius from the
// host's numeric photon-orbit band; Johannsen-Psaltis has its own RHS
// (170 flops and 23 divisions an evaluation against Kerr's 117 and 3:
// 2.3 x Kerr's attempt at the card's measured rates, and so it runs,
// PERF.md §6) and no plunge exit (no Carter constant), and has no disk
// variant: its disk emission is not defined (the JAX package raises).
//
// Work: a lane takes a ray, computes its Bardeen initial conditions and
// its certain-plunge radius (acosf exists here, so neither leaves the
// kernel as it must under Mosaic), runs its adaptive DP45 + FSAL loop over
// (r, theta, phi, p_r, p_theta) until the ray is captured, escapes or goes
// invalid, max_steps attempts are spent, or lambda >= lambda_max, then
// extracts the escape angle, half-orbit count and status itself
// (finalize, kerr_dp45_common.cuh), books the warp step sum and writes the
// ray's outputs; so a frame's trace is one launch and torch runs nothing
// per ray. One thread runs one ray, in index order, 128 threads a block,
// grid ceil(n/128). (A persistent grid, whose lanes take the next ray
// when theirs ends, gave bitwise the same outputs and was slower at every
// register budget: PERF.md §6.)
//
// What bounds it: arithmetic and the slowest ray. Each attempt makes 6 new
// RHS evaluations, each with a sinf, a cosf and three reciprocals, while a
// ray moves only about 21 bytes through device memory (9 in, 12 out; twice
// that in float64). The state lives in registers for the whole loop. Ray
// lifetimes range from tens of attempts to 166 on the main path, yet a
// warp's lanes stay 92 % busy on its image grid (raster neighbours have
// like lifetimes); what limits the launch is the dependent chain of each
// attempt, so the kernel asks for occupancy (kBlocksPerSm).
//
// A lane whose state freezes bitwise in an exact cycle of (h, lambda)
// (kerr_dp45_common.cuh, CycleWatch) would repeat that cycle until
// max_steps; the loop counts those attempts at once instead (cycle_exit =
// 1; 0 grinds them, for the bitwise check), which gives the same outputs.
// A ray just off the polar axis of the config-4 disk grid grinds so on the
// card: this loop has no frozen-state window.
//
// The disk variant (kDisk; entry lpt_kerr_dp45 with disk = 1) replaces
// the same Pallas kernel with its disk_plane recorder
// (trace_disk_rays_pallas): after each accepted step it locates a
// crossing of cos(theta) = plane_c
// on the step's interpolant and keeps the first kMaxHits in-disk
// crossings in registers (5 to 17 more live values). A frozen state
// cannot cross the plane, so the cycle exit leaves the hit record alone.
// This file's disk instances hold 1 to 4 slots, one instance a count. The
// wide instances, for 5 to 8 slots, are one instance of capacity
// kWideSlots that takes the count at run time (DiskParams::max_hits): the
// sources kerr_dp45_wide.cu and its f64 and DOP853 siblings include this
// file with LPT_WIDE (entries lpt_kerr_dp45_wide, _wide_f64,
// _wide_dop853, _wide_dop853_f64) and build nothing else, in the lazily
// built "more" and "dop853" libraries. A ray's attempts do not depend on
// its slots, so the first slots of a wide record are the narrow
// instance's. Tilted, warped and second planes and the crossing-time
// recorder are the plane recorder's instances (kerr_planes.cuh, built by
// kerr_dp45_planes.cu and its siblings with LPT_PLANES).
//
// Numerics follow the JAX package's dp45_integrate in the scalar type of
// the instance (kerr_dp45_common.cuh): this file builds the float
// instances, kerr_dp45_f64.cu the double ones (entries *_f64). Build
// without --use_fast_math: the approximate __sinf/__cosf lose accuracy
// once |theta| or |phi| grows (over-the-pole rays in the double-cover
// chart). The package builds with -fmad=false (ops/cuda/_build.py): no
// a*b + c is contracted into an FMA, so every product and sum rounds
// apart, as in the plain version and the JAX package on the CPU. A ray's
// result is then a fixed sequence of IEEE operations and libdevice calls,
// whichever lane runs it and when; it still differs from the plain
// version's on the CPU where the math libraries round sin, cos or pow
// otherwise.
//
// Two embedded pairs, as the Pallas kernel's `method`: this file builds the
// DP45 instances; kerr_dop853.cu and kerr_dop853_f64.cu include it with
// LPT_DOP853 and build the DOP853 ones (kernels kerr_dop853_kernel,
// entries lpt_kerr_dp45_dop853 and lpt_kerr_dp45_dop853_f64, linked into
// their own library): there the attempt's stages and error norm are
// kerr_dop853.cuh's (eleven new stages and the end stage, so 12 RHS
// evaluations an attempt against DP45's 6), and everything else is this
// file's. The shadow variant also takes the JAX package's event_interp
// (KerrCall::event_interp): capture and escape on the Hermite interpolant,
// or at the linear crossing fraction. It is read only on an attempt that
// found an event; the disk variant is Hermite only, as the Pallas disk
// wrapper is.
//
// Two charts, as the Pallas kernel's `formulation`: theta, built here, and
// mu = cos(theta), built by kerr_dp45_mu.cu and its f64 and DOP853
// siblings, which include this file with LPT_MU (entries lpt_kerr_dp45_mu,
// _mu_f64, _mu_dop853, _mu_dop853_f64). The mu instances are shadow
// variants of Kerr and Kerr-Newman only (the disk variant refuses the
// chart, as the JAX package does, and Johannsen-Psaltis has no mu RHS):
// the lane converts its start to (r, mu, phi, p_r, p_mu) (state_to_mu),
// integrates with rhs5_mu, which calls no sin or cos, weighs mu's error
// on the theta scale, and converts back (state_from_mu, an acosf and a
// sqrtf) before its extraction. They also take the hybrid tracer's
// force_invalid mask: a masked ray starts INVALID and makes no attempt.

#include "kerr_dp45_common.cuh"
#include "kerr_dop853.cuh"

namespace {

// Disk-plane settings of the disk variant: the annulus r_in <= r <= r_out
// of the plane cos(theta) = plane_c, whether it stops rays, and the slots
// a ray records (read by the wide instances; the others hold their count
// as kMaxHits).
template <class T>
struct DiskParams {
  T r_in, r_out, plane_c;
  int opaque, max_hits;
};

// Slots of the wide disk instances, the most a launch can record.
constexpr int kWideSlots = 8;

// What one DP45 attempt produced.
template <class T>
struct Attempt {
  T k7[5];     // FSAL stage, the derivative at y5
  T y_acc[5];  // state if accepted: y5, or the event point
  T h_eff, frac, h_new;
  bool accept, cap, esc, underflow;
};

// The rest of an attempt whose stages made y5, the end stage A.k7 and the
// error norm: capture/escape located on the step's cubic Hermite
// interpolant (or, with `linear`, at the linear crossing fraction) and the
// step-size control, 0.9 err^exponent (one pow serves both shrink and
// grow). Shared by both pairs.
template <class T>
__device__ __forceinline__ void close_attempt(
    const T y[5], const T k1[5], const T y5[5], T h, T h_eff, T err_norm,
    bool finite_ok, T exponent, T r_capture, T r_escape, T r_plunge,
    bool linear, const Params<T>& P, Attempt<T>& A) {
  const T* k7 = A.k7;
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
    if (linear) {
      frac = frac_lin;
#pragma unroll
      for (int c = 0; c < 5; ++c) A.y_acc[c] = y[c] + frac * (y5[c] - y[c]);
    } else {
      frac = hermite_crossing_frac(r_prev, r_next, k1[0], k7[0], h_eff,
                                   target, frac_lin);
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
  }

  const T factor = T(0.9) * pow_(jmax(err_norm, T(1e-30)), exponent);
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

// One adaptive DP45 attempt from (y, k1) with step h: the six new stages
// and the embedded error norm, then close_attempt. Shared by the shadow
// and disk variants; the caller applies the result.
template <int F, bool kMu, class T>
__device__ __forceinline__ void dp45_attempt(
    const T (&y)[5], const T (&k1)[5], T h, T lam, T lam_max, T p_t,
    T p_phi, T atol, T rtol, T r_capture, T r_escape, T r_plunge,
    bool linear, const Params<T>& P, Attempt<T>& A) {
  using K = Tab<T>;
  const T h_eff = jmax(jmin(h, lam_max - lam), T(0.0));

  T yt[5], k2[5], k3[5], k4[5], k5[5], k6[5], y5[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) yt[c] = y[c] + h_eff * (K::A21 * k1[c]);
  rhs5_chart<F, kMu>(yt, p_t, p_phi, P, k2);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    yt[c] = y[c] + h_eff * (K::A31 * k1[c] + K::A32 * k2[c]);
  rhs5_chart<F, kMu>(yt, p_t, p_phi, P, k3);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    yt[c] = y[c] + h_eff * (K::A41 * k1[c] + K::A42 * k2[c] +
                            K::A43 * k3[c]);
  rhs5_chart<F, kMu>(yt, p_t, p_phi, P, k4);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    yt[c] = y[c] + h_eff * (K::A51 * k1[c] + K::A52 * k2[c] +
                            K::A53 * k3[c] + K::A54 * k4[c]);
  rhs5_chart<F, kMu>(yt, p_t, p_phi, P, k5);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    yt[c] = y[c] + h_eff * (K::A61 * k1[c] + K::A62 * k2[c] +
                            K::A63 * k3[c] + K::A64 * k4[c] +
                            K::A65 * k5[c]);
  rhs5_chart<F, kMu>(yt, p_t, p_phi, P, k6);
#pragma unroll
  for (int c = 0; c < 5; ++c)
    y5[c] = y[c] + h_eff * (K::B1 * k1[c] + K::B3 * k3[c] + K::B4 * k4[c] +
                            K::B5 * k5[c] + K::B6 * k6[c]);
  T* k7 = A.k7;
  rhs5_chart<F, kMu>(y5, p_t, p_phi, P, k7);

  const bool finite_ok = all_finite(y5) && (y5[0] > T(0.0));

  // error scale (increment-aware in float32) and embedded error norm
  T err_sq = T(0.0);
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const T scale = error_scale(y[c], y5[c], k1[c], k7[c], h_eff, atol,
                                rtol, kMu && c == 1);
    const T err = h_eff * (K::E1 * k1[c] + K::E3 * k3[c] + K::E4 * k4[c] +
                           K::E5 * k5[c] + K::E6 * k6[c] + K::E7 * k7[c]);
    const T q = finite_ok ? err / scale : T(0.0);
    err_sq = err_sq + q * q;
  }
  const T err_norm = sqrt_(err_sq / T(5.0));
  close_attempt(y, k1, y5, h, h_eff, err_norm, finite_ok, T(-0.2),
                r_capture, r_escape, r_plunge, linear, P, A);
}

// One adaptive DOP853 attempt: dop853_stages (kerr_dop853.cuh), then
// close_attempt with the exponent -1/8 of its 7th-order control.
template <int F, bool kMu, class T>
__device__ __forceinline__ void dop853_attempt(
    const T (&y)[5], const T (&k1)[5], T h, T lam, T lam_max, T p_t,
    T p_phi, T atol, T rtol, T r_capture, T r_escape, T r_plunge,
    bool linear, const Params<T>& P, Attempt<T>& A) {
  const T h_eff = jmax(jmin(h, lam_max - lam), T(0.0));
  T y5[5];
  bool finite_ok;
  const T err_norm = dop853_stages<kMu>(
      y, k1, h_eff, atol, rtol,
      [&](const T(&yt)[5], T(&out)[5]) {
        rhs5_chart<F, kMu>(yt, p_t, p_phi, P, out);
      },
      y5, A.k7, finite_ok);
  close_attempt(y, k1, y5, h, h_eff, err_norm, finite_ok, T(-0.125),
                r_capture, r_escape, r_plunge, linear, P, A);
}

// One call of a C entry point, filled by the Python wrapper
// (ops/cuda/kerr_trace_kernel.py KerrCall and KerrCall64, field for
// field): device pointers, the stream, and the launch's scalars.
// refine: one byte a ray (shadow; null in disk mode); force_invalid: one
// byte a ray, read by the mu instances only (may be null there): a
// nonzero byte starts the ray INVALID. Per ray the kernel writes
// final_alpha, n_half and
// the folded status; flags (may be null) marks a ray whose raw status is
// still RUNNING (the two-pass drivers re-trace it); the disk variant also
// writes p_phi and the hit records (hits: int32 a ray; r_hits, phi_hits
// and, with momentum, pr_hits, pth_hits: (max_hits, n), slot-major). The
// probe's outputs may be null: state (5, n), raw_status, steps
// (attempts), census (CycleWatch::census), and p_phi in the shadow
// variant (the mu instances write the state converted back to theta).
// warp_steps: the warp step sum, zeroed by the entry. chart: 0 theta, 1
// mu, the chart of the entry it is handed to.
// cycle_exit = 0 grinds exact cycles instead of counting them;
// event_interp = 1 locates capture and escape at the linear crossing
// fraction instead of on the Hermite interpolant (shadow variant only).
template <class T>
struct KerrCall {
  const T *alpha, *theta;
  const unsigned char *refine, *force_invalid;
  T* final_alpha;
  int *n_half, *status;
  unsigned char* flags;
  T *p_phi;
  int* hits;
  T *r_hits, *phi_hits, *pr_hits, *pth_hits;
  T* state;
  int *raw_status, *steps, *census;
  unsigned long long* warp_steps;
  void* stream;
  int n, max_steps, cycle_exit, max_hits, momentum, opaque, family,
      event_interp, chart;
  T M, a, r_plus, r_obs, theta_obs, lambda_max, atol, rtol, atol_ref,
      rtol_ref, h_min, tiny_err, h_init, r_capture, r_reclass, r_in,
      r_out_disk, plane_c, q2, r_pro, eps3, r_freeze;
};

// The wrapper mirrors the struct with ctypes (natural alignment: the
// pointers, the ints, then the scalars of T).
static_assert(sizeof(KerrCall<float>) == 288, "KerrCall layout");
static_assert(sizeof(KerrCall<double>) == 376, "KerrCall64 layout");

// One ray in a lane's registers: its constants, its integration state and
// (disk variant) its crossing records, with the steps of its life: start
// (initial conditions and plunge radius), attempt (one DP45 attempt and
// its bookkeeping), finish (extraction and outputs). F: the metric family;
// kMu: the mu chart (y holds (r, mu, phi, p_r, p_mu) between start and
// finish).
template <class T, int F, bool kDisk, int kMaxHits, bool kMomentum,
          bool kMu>
struct Ray {
  static constexpr int kSlots = kDisk ? kMaxHits : 1;
  static constexpr int kMomSlots = kMomentum ? kMaxHits : 1;
  // The wide instance records the launch's count of slots, at most kSlots.
  static constexpr bool kRuntimeSlots = kDisk && kMaxHits == kWideSlots;

  T atol, rtol, r_plunge, p_t, p_phi;
  T y[5], k1[5];
  T h, lam;
  int status, steps, n_hits;
  CycleWatch<T> watch;
  T r_hits[kSlots], phi_hits[kSlots], pr_hits[kMomSlots],
      pth_hits[kMomSlots];

  __device__ __forceinline__ void start(const KerrCall<T>& C,
                                        const Params<T>& P, int i) {
    const T M = P.M, a = P.a;
    atol = P.atol;
    rtol = P.rtol;
    if constexpr (!kDisk) {
      const bool ref = C.refine[i] != 0;
      atol = ref ? P.atol_ref : P.atol;
      rtol = ref ? P.rtol_ref : P.rtol;
    }

    // ---- Bardeen initial conditions (models/kerr.py initial_conditions_5d)
    const RayStart<T> S = initial_state<F>(C.alpha[i], C.theta[i], P);
    p_t = S.p_t;
    p_phi = S.p_phi;

    // ---- certain-plunge radius (models/kerr.py and kerr_newman.py
    // plunge_radii: Bardeen's prograde radius for Kerr, the host's numeric
    // one for Kerr-Newman); radius 0, which no accepted step reaches,
    // disables the exit in disk mode and for Johannsen-Psaltis
    r_plunge = T(0.0);
    if constexpr (!kDisk && F != kJohannsenPsaltis) {
      const T rho_p = P.r_obs * S.sin_al * sqrt_(S.Sigma) /
                      sqrt_(jmax(S.Delta, T(1e-30)));
      const T as_p = -rho_p * S.sin_scr;
      const T bs_p = -rho_p * S.cos_scr;
      const T eta_p =
          bs_p * bs_p + S.cos_th * S.cos_th * (as_p * as_p - a * a);
      T r_pro = P.r_pro;
      if constexpr (F == kKerr) {
        const T ratio = jclip(-a / jmax(M, T(1e-30)), -T(1.0), T(1.0));
        r_pro = T(2.0) * M * (T(1.0) + cos_(T(2.0 / 3.0) * acos_(ratio)));
      }
      r_plunge = eta_p >= T(0.0) ? T(0.999) * r_pro : T(0.0);
    }

#pragma unroll
    for (int c = 0; c < 5; ++c) y[c] = S.y[c];
    bool invalid = S.bad_obs;
    if constexpr (kMu) {
      state_to_mu(y);
      if (C.force_invalid != nullptr) invalid = invalid || C.force_invalid[i];
    }
    rhs5_chart<F, kMu>(y, p_t, p_phi, P, k1);
    h = P.h_init;
    lam = T(0.0);
    status = invalid ? kInvalid : kRunning;
    steps = 0;
    watch = CycleWatch<T>();
    n_hits = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) r_hits[s] = phi_hits[s] = T(0.0);
#pragma unroll
    for (int s = 0; s < kMomSlots; ++s) pr_hits[s] = pth_hits[s] = T(0.0);
  }

  // The loop condition of ops/kerr_trace.py dp45_integrate.
  __device__ __forceinline__ bool running(const Params<T>& P) const {
    return steps < P.max_steps && status == kRunning && lam < P.lambda_max;
  }

  __device__ __forceinline__ void attempt(const Params<T>& P,
                                          const DiskParams<T>& D,
                                          int cycle_exit, bool linear) {
    const T r_capture = P.r_capture;
    const T r_escape = P.r_obs * T(2.0);
    const T lam_max = P.lambda_max;
    ++steps;
    Attempt<T> A;
    if constexpr (kDop853)
      dop853_attempt<F, kMu>(y, k1, h, lam, lam_max, p_t, p_phi, atol,
                             rtol, r_capture, r_escape, r_plunge, linear, P,
                             A);
    else
      dp45_attempt<F, kMu>(y, k1, h, lam, lam_max, p_t, p_phi, atol, rtol,
                           r_capture, r_escape, r_plunge, linear, P, A);
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
            int cap = kSlots;
            if constexpr (kRuntimeSlots) cap = D.max_hits;
            n_hits = n_hits + 1 < cap ? n_hits + 1 : cap;
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
    const bool going = status == kRunning && lam < lam_max;
    if (watch.update(!moved && !recorded, A.accept && !event, h, lam,
                     going) &&
        cycle_exit)
      steps = P.max_steps;
  }

  __device__ __forceinline__ void finish(const KerrCall<T>& C,
                                         const Params<T>& P, int i) {
    const int n = C.n;
    if constexpr (kMu) state_from_mu(y);
    const Final<T> Fin =
        finalize<F>(y, p_t, p_phi, status, C.r_reclass, P);
    C.final_alpha[i] = Fin.alpha;
    C.n_half[i] = Fin.n_half;
    C.status[i] = Fin.status;
    if (C.flags != nullptr)
      C.flags[i] = static_cast<unsigned char>(status == kRunning);
    if (C.state != nullptr) {
#pragma unroll
      for (int c = 0; c < 5; ++c)
        C.state[static_cast<size_t>(c) * n + i] = y[c];
    }
    if (C.raw_status != nullptr) C.raw_status[i] = status;
    if (C.steps != nullptr) C.steps[i] = steps;
    if (C.census != nullptr) C.census[i] = watch.census();
    if (C.p_phi != nullptr) C.p_phi[i] = p_phi;
    if constexpr (kDisk) {
      C.hits[i] = n_hits;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if constexpr (kRuntimeSlots) {
          if (s >= C.max_hits) break;
        }
        const size_t k = static_cast<size_t>(s) * n + i;
        C.r_hits[k] = r_hits[s];
        C.phi_hits[k] = phi_hits[s];
        if constexpr (kMomentum) {
          C.pr_hits[k] = pr_hits[s];
          C.pth_hits[k] = pth_hits[s];
        }
      }
    }
  }
};

// The blocks of kThreads that one SM must hold at once, the second bound
// of __launch_bounds__ (a thread then gets at most 65,536 / (kThreads x
// blocks), 72 as ptxas allocates them). Left free, nvcc gives the float
// shadow instance 88 registers (5 blocks an SM) and the double ones
// 158-166; at 7 blocks, with some spilled to L1, the double disk instance
// runs 6 % faster, both shadow instances within 1 % and the float disk
// one slower (PERF.md §6). The wide disk instances hold 32 more values
// a thread with momentum and ask for fewer blocks (kWideBlocksPerSm).
constexpr int kBlocksPerSm = 7;
constexpr int kWideBlocksPerSm = 5;

// The ray kernel, one thread a ray. kDisk = false is the shadow variant
// (the per-ray axis-refine tolerances, the certain-plunge exit). kDisk =
// true adds the plane-crossing recorder of the JAX package's disk mode
// and drops both: base tolerances everywhere and no plunge exit. It keeps
// the first kMaxHits in-disk crossings per ray (radius and physical
// azimuth, plus p_r and p_theta when kMomentum) in registers. The warp
// adds its largest attempt count to the warp step sum: the warp is the
// group of 32 consecutive rays that ops/types.py sums over (lanes past n
// count 0).
template <class T, int F, bool kDisk, int kMaxHits, bool kMomentum,
          bool kMu>
__global__ void __launch_bounds__(
    kThreads, kMaxHits == kWideSlots ? kWideBlocksPerSm : kBlocksPerSm)
LPT_KERNEL(kernel)(KerrCall<T> C, Params<T> P, DiskParams<T> D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0;
  if (i < C.n) {
    Ray<T, F, kDisk, kMaxHits, kMomentum, kMu> R;
    R.start(C, P, i);
    const bool linear = C.event_interp != 0;
    while (R.running(P)) R.attempt(P, D, C.cycle_exit, linear);
    R.finish(C, P, i);
    steps = R.steps;
  }
  const unsigned int warp_max =
      __reduce_max_sync(kFullMask, static_cast<unsigned int>(steps));
  if ((threadIdx.x & 31) == 0 && warp_max != 0)
    atomicAdd(C.warp_steps, static_cast<unsigned long long>(warp_max));
}

// Zeroes the warp step sum and launches the instance on C.stream.
template <int F, bool kDisk, int kMaxHits, bool kMomentum, bool kMu = false>
int launch(const KerrCall<Real>& C, const Params<Real>& P,
           const DiskParams<Real>& D) {
  const cudaStream_t s = static_cast<cudaStream_t>(C.stream);
  const cudaError_t err =
      cudaMemsetAsync(C.warp_steps, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess || C.n <= 0) return static_cast<int>(err);
  LPT_KERNEL(kernel)<Real, F, kDisk, kMaxHits, kMomentum, kMu>
      <<<(C.n + kThreads - 1) / kThreads, kThreads, 0, s>>>(C, P, D);
  return static_cast<int>(cudaGetLastError());
}

// The shadow variant (disk = 0) or the disk variant of family F; in the
// wide build, the wide disk instance for 5 to kWideSlots slots.
template <int F>
int launch_family(const KerrCall<Real>& C, const Params<Real>& P,
                  const DiskParams<Real>& D, int disk) {
#ifdef LPT_WIDE
  if (!disk || C.max_hits <= 4 || C.max_hits > kWideSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C.momentum) return launch<F, true, kWideSlots, true>(C, P, D);
  return launch<F, true, kWideSlots, false>(C, P, D);
#else
  if (!disk) return launch<F, false, 1, false>(C, P, D);
  switch (C.max_hits * 2 + (C.momentum != 0)) {
    case 2: return launch<F, true, 1, false>(C, P, D);
    case 3: return launch<F, true, 1, true>(C, P, D);
    case 4: return launch<F, true, 2, false>(C, P, D);
    case 5: return launch<F, true, 2, true>(C, P, D);
    case 6: return launch<F, true, 3, false>(C, P, D);
    case 7: return launch<F, true, 3, true>(C, P, D);
    case 8: return launch<F, true, 4, false>(C, P, D);
    case 9: return launch<F, true, 4, true>(C, P, D);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}

}  // namespace

#ifdef LPT_PLANES
// kerr_dp45_planes.cu and its siblings build the plane recorder's
// instances and entry alone.
#include "kerr_planes.cuh"
#else
extern "C" {

#ifdef LPT_MU
// Launches the mu chart's shadow instance of the call's family (kKerr or
// kKerrNewman; disk must be 0 and call->chart 1) for the call `call` (a
// KerrCall of this instance's Real) and returns a cudaError_t (0 on
// success).
int LPT_ENTRY(lpt_kerr_dp45)(const void* call, int disk) {
  const KerrCall<Real>& C = *static_cast<const KerrCall<Real>*>(call);
  const Params<Real> P{C.M,        C.a,         C.r_plus,    C.r_obs,
                       C.theta_obs, C.lambda_max, C.max_steps, C.atol,
                       C.rtol,     C.atol_ref,  C.rtol_ref,  C.h_min,
                       C.tiny_err, C.h_init,    C.r_capture, C.q2,
                       C.r_pro,    C.eps3,      C.r_freeze};
  const DiskParams<Real> D{C.r_in, C.r_out_disk, C.plane_c, C.opaque,
                           C.max_hits};
  if (disk || C.chart != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (C.family) {
    case kKerr: return launch<kKerr, false, 1, false, true>(C, P, D);
    case kKerrNewman:
      return launch<kKerrNewman, false, 1, false, true>(C, P, D);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#else
// Launches the shadow variant (disk = 0) or the disk variant (disk = 1:
// max_hits 1..4, momentum 0 or 1) of the call's family (kKerr,
// kKerrNewman, kJohannsenPsaltis; the last has no disk variant) for the
// call `call` (a KerrCall of this instance's Real: float here, double in
// the *_f64 entry; chart 0) and returns a cudaError_t (0 on success). The
// wide entries (LPT_WIDE) launch the disk variant of Kerr and Kerr-Newman
// only, for max_hits 5..8.
int LPT_ENTRY(lpt_kerr_dp45)(const void* call, int disk) {
  const KerrCall<Real>& C = *static_cast<const KerrCall<Real>*>(call);
  const Params<Real> P{C.M,        C.a,         C.r_plus,    C.r_obs,
                       C.theta_obs, C.lambda_max, C.max_steps, C.atol,
                       C.rtol,     C.atol_ref,  C.rtol_ref,  C.h_min,
                       C.tiny_err, C.h_init,    C.r_capture, C.q2,
                       C.r_pro,    C.eps3,      C.r_freeze};
  const DiskParams<Real> D{C.r_in, C.r_out_disk, C.plane_c, C.opaque,
                           C.max_hits};
  // the disk variant locates its events on the Hermite interpolant only
  if (disk && C.event_interp) return static_cast<int>(cudaErrorInvalidValue);
  if (C.chart != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (C.family) {
    case kKerr: return launch_family<kKerr>(C, P, D, disk);
    case kKerrNewman: return launch_family<kKerrNewman>(C, P, D, disk);
#ifndef LPT_WIDE
    case kJohannsenPsaltis:
      if (disk) return static_cast<int>(cudaErrorInvalidValue);
      return launch<kJohannsenPsaltis, false, 1, false>(C, P, D);
#endif
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#endif  // LPT_MU

#if !defined(LPT_DOUBLE) && !defined(LPT_WIDE) && \
    !(defined(LPT_MU) && defined(LPT_DOP853))
// One a library: kerr_dp45.cu's DP45 build, kerr_dp45_mu.cu's (the
// library of the mu, Kerr-Newman-extras and wide instances) or
// kerr_dop853.cu's.
const char* lpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif

}  // extern "C"
#endif  // LPT_PLANES
