// The photon-ring order decomposition on the Kerr DP45 extras kernel
// (kerr_dp45_extras.cuh), for Hopper (sm_90a): the path emission binned by
// image order, all orders in one trace.
//
// Replaces the Pallas TPU kernel
//   light_path_tracer_tpu/ops/pallas/volumetric_kernel.py::_extras_tile_kernel
//     (entry trace_rays_aux_pallas / trace_rays_spectral_pallas)
// for the transfer function of
//   light_path_tracer_tpu/volumetric.py::make_order_transfer.
// The plain PyTorch version is ops/kerr_trace.py trace_rays_spectral over
// light_path_tracer_tpu_torch/volumetric.py make_order_transfer; the
// wrapper is ops/cuda/volumetric_kernel.py trace_rays_aux_cuda.
//
// Extras (m, [tau,] I_0..I_{N-1}): the winding coordinate m integrates a
// unit-mass Gaussian bump in cos(theta) once per equatorial crossing,
//   dm = norm exp(-cos^2(theta) / 2 sigma^2) |sin theta| |p_theta| / Sigma,
// and the emission g^p j (screened by exp(-max(tau, -30)) with absorption)
// lands in bucket floor(max(m, 0)), the last bucket open-ended. The
// integrand is discontinuous where m crosses an integer, so a step that
// straddles the edge is rejected until it is short enough; kOrders is 2..4.
//
// What bounds it: arithmetic, as the thin form, with one more expf, a
// division and the bucket selects per RHS (ops/cuda/bounds.py; sin and
// cos of theta come from the geodesic's evaluation); 8 to 11 components.
// A ray reads 8 bytes and writes 4 (kExtras + 4).

#include "kerr_dp45_extras.cuh"

namespace {

template <int kOrders, bool kAbsorbing, class T>
struct Order {
  static constexpr int kExtras = 1 + (kAbsorbing ? 1 : 0) + kOrders;
  static constexpr int kAux = 0;
  static constexpr int kMinBlocks =
      kSingle<T> ? (kAbsorbing ? 7 : 6) : (kAbsorbing ? 6 : 3);
  __device__ static void eval(const T* y, Trig<T> tr, T p_t, T p_phi,
                              const Params<T>&, const RiafParams<T>& R,
                              const T*, T* d) {
    const T r = y[0];
    const T c = tr.c;
    const Source<T> s = source(y, c, p_t, p_phi, R);
    const T sigma_bl = r * r + R.a2 * c * c;
    d[0] = R.order_norm * exp_(-c * c * R.order_inv_two_sig2) *
           abs_(tr.s) * abs_(y[4]) / sigma_bl;
    // RK stage probes can push m slightly negative: bucket 0.
    const T bucket = floor_(jmax(y[5], T(0.0)));
    T em = s.em;
    if (kAbsorbing) {
      d[1] = opacity(s, R);
      em = em * exp_(-jmax(y[6], -T(30.0)));
    }
#pragma unroll
    for (int n = 0; n < kOrders; ++n) {
      const T edge = static_cast<T>(n);
      const bool in = n < kOrders - 1 ? bucket == edge : bucket >= edge;
      d[1 + (kAbsorbing ? 1 : 0) + n] = in ? em : T(0.0);
    }
  }
};

// The functors of this source by (form, variant): variant = the number
// of orders (2..4), form 1 = with absorption.
struct Forms {
  template <class Fn>
  int operator()(int form, int variant, Fn&& fn) const {
    switch (10 * (form != 0) + variant) {
      case 2: return fn(Tag<Order<2, false, Real>>());
      case 3: return fn(Tag<Order<3, false, Real>>());
      case 4: return fn(Tag<Order<4, false, Real>>());
      case 12: return fn(Tag<Order<2, true, Real>>());
      case 13: return fn(Tag<Order<3, true, Real>>());
      case 14: return fn(Tag<Order<4, true, Real>>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

}  // namespace

extern "C" {

// Launches Order<call->variant, call->form != 0> for `call` (an
// ExtrasCall of Real; variant = the number of orders, 2..4; form 1 = with
// absorption) with the RiafParams of Real at `riaf`; returns a cudaError_t
// (0 on success).
int LPT_ENTRY(lpt_kerr_dp45_orders)(const void* call, const void* riaf) {
  return run_entry(call, riaf, Forms());
}

// The resources of the instance of (form, variant) on the current card
// into out[0..3] (describe in kerr_dp45_extras.cuh); a cudaError_t.
int LPT_ENTRY(lpt_kerr_dp45_orders_describe)(int form, int variant,
                                              int* out) {
  return describe_entry(form, variant, out, Forms());
}

}  // extern "C"
