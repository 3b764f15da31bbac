// The plane recorder of the Kerr ray kernel's disk variant (kerr_dp45.cu):
// tilted, warped and second disk planes, and the crossing-time recorder.
//
// Replaces what the JAX package runs outside its Pallas disk kernel
// (light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py::
// trace_disk_rays_pallas, rows #3 and #4 of PERF.md §6): there the
// tilted and warped recorder, the multi-plane disk and record_time run on
// XLA (light_path_tracer_tpu/disk.py:306-316), because Mosaic lowers no
// atan2 and the Pallas output refs carry no time slots. On the card they
// are one more instance set of the same kernel. The plain version is
// ops/kerr_trace.py dp45_integrate with disk_normal, extra_disks and
// record_time (its _Plane and WarpedBasis); the wrapper is
// ops/cuda/kerr_trace_kernel.py _trace_planes.
//
// A lane runs the disk variant's loop (base tolerances, no plunge exit,
// Hermite events) with up to kMaxPlanes planes, each read from the
// launch's PlaneSet at run time (the broad instances: any number, from a
// PlaneList in device memory, below):
//   kind 0, the equatorial detector cos(theta) - plane_c and the physical
//     azimuth (phi + pi where sin(theta) < 0);
//   kind 1, a flat tilted plane of basis (n, e1, e2): the detector
//     n . xhat(theta, phi), the in-plane azimuth atan2(xhat . e2,
//     xhat . e1) and xi, the ray's angular momentum about n (n . L with
//     sin(theta) clamped at 1e-12 keeping its sign);
//   kind 2, a Bardeen-Petterson warp: kind 1 with the basis of the tilt
//     iota(r) = tilt / (1 + (warp_radius / r)^power) at each point.
// Each accepted step locates each plane's crossing as the disk variant
// does; an in-disk crossing fills the plane's next slot (the launch's
// max_hits a plane, any number). The ray parks at its first in-disk crossing of
// an opaque plane, the first in list order, as ESCAPED. With record_time
// the lane also carries the coordinate time t from the camera, a
// trapezoid of tdot over each accepted (event-shortened) segment and
// over the sub-segment to each crossing; t_end is its value at the end
// (at the parking crossing for an opaque stop).
//
// What bounds it: the disk variant's arithmetic (6 RHS evaluations an
// attempt for DP45), plus per accepted attempt each plane's detector at
// the step's end (a warp: a pow, a sine and a cosine for its basis) and,
// with record_time, one tdot, on one set of sines and cosines of theta
// and phi a state (Trig). The detectors and tdot at the step's start are
// the previous step's ends, which the lane carries (d, td). The records
// go straight to device memory when a slot fills (a slot is written
// once, the outputs start at zero), so the slots cost no registers: the
// lane holds the disk variant's state, the planes' counts and detectors,
// and the time.
//
// Any number of planes (the broad instances, kerr_dp45_broad_planes.cu and
// its siblings with LPT_BROAD_PLANES, entries lpt_kerr_dp45_broad_planes*,
// in the "broad" library): the same lane over a PlaneList, whose planes
// lie in device memory, with each plane's detectors (at the step's start
// and end, two rows that swap on an accept) in a workspace of 2 n_planes
// n scalars and its crossing count in its hits output; the plane count is
// read at run time and the loops over the planes do not unroll. The 1-
// and 2-plane instances keep their registers (PlaneRegs).
//
// Numerics: every operation in the plain loop's order, built with
// -fmad=false as every source; the float64 instances build as
// relocatable device code whose pow_ is lpt_pow_f64.cu's (built with
// contraction, as PyTorch's own pow, which the plain loop's warp and
// step control call on the card).

#pragma once

namespace {

constexpr int kMaxPlanes = 2;

// One plane of a launch (ops/cuda/kerr_trace_kernel.py PlaneSpec, field
// for field): kind (0 equatorial, 1 flat basis, 2 warp), whether it
// stops rays, its outputs (hits: int32 a ray; r, phi, xi, t, pr, pth:
// (max_hits, n) slot-major, null where not recorded: xi on kind 0, t
// without record_time, pr and pth without momentum), and its numbers in
// double, rounded to the instance's type where they are read.
struct PlaneSpec {
  int kind, opaque;
  int* hits;
  void *r, *phi, *xi, *t, *pr, *pth;
  double r_in, r_out, plane_c, tilt, sl, cl, warp_radius, power;
  double basis[9];  // kind 1: n, e1, e2
};

// The planes of a launch, the time recorder's switch and t_end (n), and
// the probe's accepted attempts a ray (int32, may be null: the planes'
// work runs on accepted attempts, which the counted bound reads).
struct PlaneSet {
  int n_planes, record_time;
  void* t_end;
  int* accepted;
  PlaneSpec planes[kMaxPlanes];
};

// The planes of a broad launch: PlaneSet's fields with the planes in
// device memory (n_planes of them) and the detectors' workspace d (2
// n_planes n of the instance's type).
struct PlaneList {
  int n_planes, record_time;
  void* t_end;
  int* accepted;
  const PlaneSpec* planes;
  void* d;
};

static_assert(sizeof(PlaneSpec) == 200, "PlaneSpec layout");
static_assert(sizeof(PlaneSet) == 424, "PlaneSet layout");
static_assert(sizeof(PlaneList) == 40, "PlaneList layout");

// The bound of a loop over a launch's planes: a PlaneSet's kMaxPlanes (a
// constant: the loops unroll and skip the planes past n_planes), a
// PlaneList's n_planes.
__host__ __device__ __forceinline__ constexpr int plane_loop(
    const PlaneSet&) {
  return kMaxPlanes;
}
__host__ __device__ __forceinline__ int plane_loop(const PlaneList& PS) {
  return PS.n_planes;
}

// A lane's per-plane state: each plane's detector at the step's start
// (d) and end (d_next), and its count of recorded crossings (hits).
// PlaneRegs holds a PlaneSet's in registers.
template <class T>
struct PlaneRegs {
  T d_[kMaxPlanes], dn_[kMaxPlanes];
  int n_[kMaxPlanes];
  __device__ __forceinline__ void bind(const PlaneSet&, int, int) {}
  __device__ __forceinline__ T& d(int p) { return d_[p]; }
  __device__ __forceinline__ T& d_next(int p) { return dn_[p]; }
  __device__ __forceinline__ int& hits(int p) { return n_[p]; }
  // the end's detectors become the next step's start's
  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) d_[p] = dn_[p];
  }
};

// A PlaneList's: the detectors in its workspace (row r of plane p at (r
// n_planes + p) n + i; the rows swap on advance), the counts in the
// planes' hits outputs.
template <class T>
struct PlaneRows {
  T* d0;
  const PlaneSpec* planes;
  int n_planes, n, i, cur;
  __device__ __forceinline__ void bind(const PlaneList& PS, int n_rays,
                                       int ray) {
    d0 = static_cast<T*>(PS.d);
    planes = PS.planes;
    n_planes = PS.n_planes;
    n = n_rays;
    i = ray;
    cur = 0;
  }
  __device__ __forceinline__ T& row(int r, int p) {
    return d0[(static_cast<size_t>(r) * n_planes + p) * n + i];
  }
  __device__ __forceinline__ T& d(int p) { return row(cur, p); }
  __device__ __forceinline__ T& d_next(int p) { return row(cur ^ 1, p); }
  __device__ __forceinline__ int& hits(int p) { return planes[p].hits[i]; }
  __device__ __forceinline__ void advance() { cur ^= 1; }
};

template <class T, class Set>
struct LaneOf;
template <class T>
struct LaneOf<T, PlaneSet> {
  using type = PlaneRegs<T>;
};
template <class T>
struct LaneOf<T, PlaneList> {
  using type = PlaneRows<T>;
};

template <class T>
struct Basis {
  T n[3], e1[3], e2[3];
};

// The plane's basis at radius r (kinds 1 and 2), as disk.disk_basis and
// ops/kerr_trace.py WarpedBasis compute it.
template <class T>
__device__ __forceinline__ Basis<T> basis_at(const PlaneSpec& S, T r) {
  Basis<T> B;
  if (S.kind == 2) {
    const T sl = T(S.sl), cl = T(S.cl);
    const T ratio = T(S.warp_radius) / jmax(r, T(1e-6));
    const T iota = T(S.tilt) / (T(1.0) + pow_(ratio, T(S.power)));
    const T si = sin_(iota), ci = cos_(iota);
    B.n[0] = si * sl;
    B.n[1] = -si * cl;
    B.n[2] = ci;
    B.e1[0] = cl;
    B.e1[1] = sl;
    B.e1[2] = T(0.0);
    B.e2[0] = -sl * ci;
    B.e2[1] = cl * ci;
    B.e2[2] = si;
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      B.n[k] = T(S.basis[k]);
      B.e1[k] = T(S.basis[3 + k]);
      B.e2[k] = T(S.basis[6 + k]);
    }
  }
  return B;
}

// The sines and cosines of a state's theta and phi, each taken once for
// every plane and tdot that read them: sin(theta) where `sth` (a tilted
// plane, the time recorder, kind 0's azimuth), cos(theta) where `cth`,
// phi's where `tilted`; the others stay 0.
template <class T>
struct Trig {
  T sth, cth, sph, cph;
};

template <class T>
__device__ __forceinline__ Trig<T> trig_of(const T (&ys)[5], bool sth,
                                           bool cth, bool tilted) {
  Trig<T> G{T(0.0), T(0.0), T(0.0), T(0.0)};
  if (sth) G.sth = sin_(ys[1]);
  if (cth) G.cth = cos_(ys[1]);
  if (tilted) {
    G.sph = sin_(ys[2]);
    G.cph = cos_(ys[2]);
  }
  return G;
}

// Whether a plane of the launch has a normal (kind 1 or 2).
template <class Set>
__device__ __forceinline__ bool any_tilted(const Set& PS) {
  bool tilted = false;
#pragma unroll
  for (int p = 0; p < plane_loop(PS); ++p)
    tilted = tilted || (p < PS.n_planes && PS.planes[p].kind != 0);
  return tilted;
}

// The sines and cosines the detectors and tdot read at a state.
template <class T, class Set>
__device__ __forceinline__ Trig<T> state_trig(const T (&ys)[5],
                                              const Set& PS) {
  const bool tilted = any_tilted(PS);
  return trig_of<T>(ys, tilted || PS.record_time, true, tilted);
}

// The plane's detector at a state of sines and cosines G: cos(theta) -
// plane_c, or n . xhat.
template <class T>
__device__ __forceinline__ T detector(const PlaneSpec& S, const T (&ys)[5],
                                      const Trig<T>& G) {
  if (S.kind == 0) return G.cth - T(S.plane_c);
  const Basis<T> B = basis_at<T>(S, ys[0]);
  return B.n[0] * G.sth * G.cph + B.n[1] * G.sth * G.sph + B.n[2] * G.cth;
}

// dt/dlambda = g^tt p_t + g^tphi p_phi (models/kerr.py tdot; Kerr-Newman's
// Delta and g^tphi carry Q^2, kerr_newman.py inverse_metric_terms_kn), at
// a state of sines and cosines G.
template <int F, class T>
__device__ __forceinline__ T tdot(const T (&ys)[5], const Trig<T>& G, T p_t,
                                  T p_phi, const Params<T>& P) {
  const T r = ys[0];
  const T sin_th = G.sth, cos_th = G.cth;
  const T sin2 = jmax(sin_th * sin_th, Consts<T>::kSin2Floor);
  const T r2 = r * r, a2 = P.a * P.a;
  const T Sigma = r2 + a2 * cos_th * cos_th;
  T Delta = r2 - T(2.0) * P.M * r + a2;
  if constexpr (F == kKerrNewman) Delta = Delta + P.q2;
  const T ra2 = r2 + a2;
  const T A = ra2 * ra2 - a2 * Delta * sin2;
  const T SD = Sigma * Delta;
  const T g_tt = -A / SD;
  T g_tphi;
  if constexpr (F == kKerrNewman)
    g_tphi = -P.a * (T(2.0) * P.M * r - P.q2) / SD;
  else
    g_tphi = -T(2.0) * P.M * P.a * r / SD;
  return g_tt * p_t + g_tphi * p_phi;
}

template <class T>
__device__ __forceinline__ void put(void* out, int slot, int n, int i, T v) {
  static_cast<T*>(out)[static_cast<size_t>(slot) * n + i] = v;
}

// One ray of the plane recorder in a lane's registers (the disk
// variant's Ray of kerr_dp45.cu with its records in device memory), over
// a PlaneSet or a PlaneList.
template <class T, int F, class Set = PlaneSet>
struct PlanesRay {
  T p_t, p_phi;
  T y[5], k1[5];
  T h, lam, t_now;
  T td;             // tdot at y (record_time)
  int status, steps, accepted;
  typename LaneOf<T, Set>::type L;  // the planes' detectors and counts
  CycleWatch<T> watch;

  __device__ __forceinline__ void start(const KerrCall<T>& C,
                                        const Params<T>& P,
                                        const Set& PS, int i) {
    const RayStart<T> S = initial_state<F>(C.alpha[i], C.theta[i], P);
    p_t = S.p_t;
    p_phi = S.p_phi;
#pragma unroll
    for (int c = 0; c < 5; ++c) y[c] = S.y[c];
    rhs5_chart<F, false>(y, p_t, p_phi, P, k1);
    h = P.h_init;
    lam = T(0.0);
    t_now = T(0.0);
    status = S.bad_obs ? kInvalid : kRunning;
    steps = 0;
    accepted = 0;
    watch = CycleWatch<T>();
    L.bind(PS, C.n, i);
    const Trig<T> G = state_trig<T>(y, PS);
#pragma unroll
    for (int p = 0; p < plane_loop(PS); ++p) {
      L.hits(p) = 0;
      L.d(p) = p < PS.n_planes ? detector<T>(PS.planes[p], y, G) : T(0.0);
    }
    td = PS.record_time ? tdot<F>(y, G, p_t, p_phi, P) : T(0.0);
  }

  __device__ __forceinline__ bool running(const Params<T>& P) const {
    return steps < P.max_steps && status == kRunning && lam < P.lambda_max;
  }

  __device__ __forceinline__ void attempt(const KerrCall<T>& C,
                                          const Params<T>& P,
                                          const Set& PS, int i) {
    const T lam_max = P.lambda_max;
    ++steps;
    Attempt<T> A;
    if constexpr (kDop853)
      dop853_attempt<F, false>(y, k1, h, lam, lam_max, p_t, p_phi, P.atol,
                               P.rtol, P.r_capture, P.r_obs * T(2.0), T(0.0),
                               false, P, A);
    else
      dp45_attempt<F, false>(y, k1, h, lam, lam_max, p_t, p_phi, P.atol,
                             P.rtol, P.r_capture, P.r_obs * T(2.0), T(0.0),
                             false, P, A);
    const bool event = A.cap || A.esc;

    // the status the attempt leaves before any plane parks the ray
    int st = status;
    if (A.accept) {
      if (A.cap) st = kCaptured;
      else if (A.esc) st = kEscaped;
      if (!all_finite(A.y_acc)) st = kInvalid;
    }
    if (A.underflow) st = kInvalid;

    bool recorded = false, stopped = false;
    T y_stop[5];
    T t_stop = t_now;
    // each plane's detector and tdot at the step's end (the start's are
    // the lane's L.d and td)
    T td_next = T(0.0);
    if (A.accept) {
      const T seg = A.frac * A.h_eff;
      const Trig<T> G = state_trig<T>(A.y_acc, PS);
#pragma unroll
      for (int p = 0; p < plane_loop(PS); ++p)
        L.d_next(p) =
            p < PS.n_planes ? detector<T>(PS.planes[p], A.y_acc, G) : T(0.0);
      if (PS.record_time) {
        td_next = tdot<F>(A.y_acc, G, p_t, p_phi, P);
        t_stop = t_now + T(0.5) * seg * (td + td_next);
      }
#pragma unroll
      for (int p = 0; p < plane_loop(PS); ++p) {
        if (p >= PS.n_planes) continue;
        const PlaneSpec& S = PS.planes[p];
        const T d_prev = L.d(p), d_end = L.d_next(p);
        if (!((d_prev * d_end < T(0.0)) ||
              (d_end == T(0.0) && d_prev != T(0.0))))
          continue;
        const T den = d_end == d_prev ? T(1.0) : d_end - d_prev;
        const T s = jclip(-d_prev / den, T(0.0), T(1.0));
        T yc[5];
        if (event) {
#pragma unroll
          for (int c = 0; c < 5; ++c) yc[c] = y[c] + s * (A.y_acc[c] - y[c]);
        } else {
          const T s2 = s * s, s3 = s2 * s;
          const T h00 = T(2.0) * s3 - T(3.0) * s2 + T(1.0);
          const T h10 = s3 - T(2.0) * s2 + s;
          const T h01 = -T(2.0) * s3 + T(3.0) * s2;
          const T h11 = s3 - s2;
#pragma unroll
          for (int c = 0; c < 5; ++c)
            yc[c] = h00 * y[c] + h10 * seg * k1[c] + h01 * A.y_acc[c] +
                    h11 * seg * A.k7[c];
        }
        if (!(yc[0] >= T(S.r_in) && yc[0] <= T(S.r_out))) continue;
        recorded = true;

        // the crossing's sines and cosines: sin(theta) always (kind 0's
        // azimuth, a normal's xhat, tdot), the rest where read
        const Trig<T> Gc = trig_of<T>(yc, true, S.kind != 0 || PS.record_time,
                                      S.kind != 0);
        T phi_c, xi_c = T(0.0);
        if (S.kind == 0) {
          // physical azimuth: phi + pi on the sin(theta) < 0 branch
          phi_c = Gc.sth < T(0.0) ? yc[2] + Consts<T>::kPi : yc[2];
        } else {
          const Basis<T> B = basis_at<T>(S, yc[0]);
          const T sth = Gc.sth, cth = Gc.cth;
          const T sph = Gc.sph, cph = Gc.cph;
          const T xh = sth * cph, yh = sth * sph, zh = cth;
          const T u1 = xh * B.e1[0] + yh * B.e1[1] + zh * B.e1[2];
          const T u2 = xh * B.e2[0] + yh * B.e2[1] + zh * B.e2[2];
          phi_c = atan2_(u2, u1);
          const T tiny = T(1e-12);
          const T sth_safe =
              abs_(sth) < tiny ? (sth < T(0.0) ? -tiny : tiny) : sth;
          const T cot = cth / sth_safe;
          const T pth = yc[4];
          const T lx = -sph * pth - cot * cph * p_phi;
          const T ly = cph * pth - cot * sph * p_phi;
          xi_c = B.n[0] * lx + B.n[1] * ly + B.n[2] * p_phi;
        }
        T t_c = T(0.0);
        if (PS.record_time)
          t_c = t_now + T(0.5) * (s * seg) *
                            (td + tdot<F>(yc, Gc, p_t, p_phi, P));

        const int n = L.hits(p);
        if (n < C.max_hits) {
          put(S.r, n, C.n, i, yc[0]);
          put(S.phi, n, C.n, i, phi_c);
          if (S.kind != 0) put(S.xi, n, C.n, i, xi_c);
          if (PS.record_time) put(S.t, n, C.n, i, t_c);
          if (C.momentum) {
            put(S.pr, n, C.n, i, yc[3]);
            put(S.pth, n, C.n, i, yc[4]);
          }
        }
        L.hits(p) = n + 1 < C.max_hits ? n + 1 : C.max_hits;
        // an opaque plane parks a still-running ray at its first in-disk
        // crossing; a ray captured in the same step stays captured
        if (S.opaque && L.hits(p) == 1 && st == kRunning && !stopped) {
#pragma unroll
          for (int c = 0; c < 5; ++c) y_stop[c] = yc[c];
          st = kEscaped;
          t_stop = t_c;
          stopped = true;
        }
      }
    }

    bool moved = false;
    if (A.accept) {
      ++accepted;
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
      // the end's detectors and tdot are the next step's start's (a ray
      // parked at a crossing runs no more attempts)
      L.advance();
      td = td_next;
      if (stopped) {
#pragma unroll
        for (int c = 0; c < 5; ++c) y[c] = y_stop[c];
      }
      if (PS.record_time) {
        // a clock that moves is progress the cycle exit may not skip
        moved = moved || !same_bits(t_stop, t_now);
        t_now = t_stop;
      }
    }
    status = st;
    h = A.h_new;

    // An exact cycle of a frozen lane runs to the step budget: count it.
    const bool going = status == kRunning && lam < lam_max;
    if (watch.update(!moved && !recorded, A.accept && !event, h, lam,
                     going) &&
        C.cycle_exit)
      steps = P.max_steps;
  }

  __device__ __forceinline__ void finish(const KerrCall<T>& C,
                                         const Params<T>& P,
                                         const Set& PS, int i) {
    const Final<T> Fin = finalize<F>(y, p_t, p_phi, status, C.r_reclass, P);
    C.final_alpha[i] = Fin.alpha;
    C.n_half[i] = Fin.n_half;
    C.status[i] = Fin.status;
    if (C.flags != nullptr)
      C.flags[i] = static_cast<unsigned char>(status == kRunning);
    if (C.state != nullptr) {
#pragma unroll
      for (int c = 0; c < 5; ++c)
        C.state[static_cast<size_t>(c) * C.n + i] = y[c];
    }
    if (C.raw_status != nullptr) C.raw_status[i] = status;
    if (C.steps != nullptr) C.steps[i] = steps;
    if (C.census != nullptr) C.census[i] = watch.census();
    C.p_phi[i] = p_phi;
#pragma unroll
    for (int p = 0; p < plane_loop(PS); ++p)
      if (p < PS.n_planes) PS.planes[p].hits[i] = L.hits(p);
    if (PS.record_time) static_cast<T*>(PS.t_end)[i] = t_now;
    if (PS.accepted != nullptr) PS.accepted[i] = accepted;
  }
};

// The plane-recorder kernel, one thread a ray; the warp step sum as the
// disk variant's. The block bound is the wide disk instances'.
template <class T, int F>
__global__ void __launch_bounds__(kThreads, kWideBlocksPerSm)
LPT_KERNEL(planes_kernel)(KerrCall<T> C, Params<T> P, PlaneSet PS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0;
  if (i < C.n) {
    PlanesRay<T, F> R;
    R.start(C, P, PS, i);
    while (R.running(P)) R.attempt(C, P, PS, i);
    R.finish(C, P, PS, i);
    steps = R.steps;
  }
  const unsigned int warp_max =
      __reduce_max_sync(kFullMask, static_cast<unsigned int>(steps));
  if ((threadIdx.x & 31) == 0 && warp_max != 0)
    atomicAdd(C.warp_steps, static_cast<unsigned long long>(warp_max));
}

#ifdef LPT_BROAD_PLANES
// The broad plane-recorder kernel: any number of planes (a PlaneList).
template <class T, int F>
__global__ void __launch_bounds__(kThreads, kWideBlocksPerSm)
LPT_KERNEL(planes_list_kernel)(KerrCall<T> C, Params<T> P, PlaneList PS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0;
  if (i < C.n) {
    PlanesRay<T, F, PlaneList> R;
    R.start(C, P, PS, i);
    while (R.running(P)) R.attempt(C, P, PS, i);
    R.finish(C, P, PS, i);
    steps = R.steps;
  }
  const unsigned int warp_max =
      __reduce_max_sync(kFullMask, static_cast<unsigned int>(steps));
  if ((threadIdx.x & 31) == 0 && warp_max != 0)
    atomicAdd(C.warp_steps, static_cast<unsigned long long>(warp_max));
}

using Planes = PlaneList;
#else
using Planes = PlaneSet;
#endif

template <int F>
int launch_planes(const KerrCall<Real>& C, const Params<Real>& P,
                  const Planes& PS) {
  const cudaStream_t s = static_cast<cudaStream_t>(C.stream);
  const cudaError_t err =
      cudaMemsetAsync(C.warp_steps, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess || C.n <= 0) return static_cast<int>(err);
#ifdef LPT_BROAD_PLANES
  LPT_KERNEL(planes_list_kernel)<Real, F>
      <<<(C.n + kThreads - 1) / kThreads, kThreads, 0, s>>>(C, P, PS);
#else
  LPT_KERNEL(planes_kernel)<Real, F>
      <<<(C.n + kThreads - 1) / kThreads, kThreads, 0, s>>>(C, P, PS);
#endif
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the plane-recorder instance of the call's family (kKerr or
// kKerrNewman) for the call `call` (a KerrCall of this instance's Real,
// chart 0, Hermite events; max_hits >= 1 and momentum read from it) and
// the planes `planes` (a PlaneSet of 1..kMaxPlanes planes; in the broad
// build a PlaneList of n_planes >= 1 planes and its workspace; their
// outputs start at zero); returns a cudaError_t (0 on success).
int LPT_ENTRY(lpt_kerr_dp45)(const void* call, const void* planes) {
  const KerrCall<Real>& C = *static_cast<const KerrCall<Real>*>(call);
  const Planes& PS = *static_cast<const Planes*>(planes);
  const Params<Real> P{C.M,        C.a,         C.r_plus,    C.r_obs,
                       C.theta_obs, C.lambda_max, C.max_steps, C.atol,
                       C.rtol,     C.atol_ref,  C.rtol_ref,  C.h_min,
                       C.tiny_err, C.h_init,    C.r_capture, C.q2,
                       C.r_pro,    C.eps3,      C.r_freeze};
  if (C.event_interp || C.chart != 0 || C.max_hits < 1 || PS.n_planes < 1 ||
      PS.n_planes > plane_loop(PS))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C.family) {
    case kKerr: return launch_planes<kKerr>(C, P, PS);
    case kKerrNewman: return launch_planes<kKerrNewman>(C, P, PS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
