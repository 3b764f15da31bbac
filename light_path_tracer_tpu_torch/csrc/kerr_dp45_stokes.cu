// The polarized hot-flow transfer, Stokes (I, Q, U), on the Kerr DP45
// extras kernel (kerr_dp45_extras.cuh), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   light_path_tracer_tpu/ops/pallas/volumetric_kernel.py::_extras_tile_kernel
//     (entry trace_rays_aux_pallas) with n_aux = 4 per-ray constant tiles,
// for the transfer function of
//   light_path_tracer_tpu/polarization.py::make_polarized_volumetric_transfer.
// The plain PyTorch version is ops/kerr_trace.py trace_rays_aux over
// light_path_tracer_tpu_torch/polarization.py's closure; the wrapper is
// ops/cuda/volumetric_kernel.py trace_rays_aux_cuda.
//
// Each emission element's polarization vector f ~ eps(u, k, b) is formed
// from the current state: the photon k^mu from the contravariant metric,
// the flow's circular 4-velocity u (Keplerian where timelike, ZAMO
// inside) and the field direction b (vertical, toroidal or radial: one
// switch, the same for every ray of a launch). u has only t and phi
// components, so of the Levi-Civita contraction's 24 signed terms 12
// vanish for every field; the rest are written out, each divided and
// summed as the plain loop sums them. Its Walker-Penrose
// constant is inverted through the ray's four camera-side constants
// (aux: kappa(e1), kappa(e2), read once into registers), which gives
// cos 2chi and sin 2chi by algebra alone, and
//   dI = g^p j, dQ = p0 sin^2(xi) g^p j cos 2chi, dU = ... sin 2chi
// with sin(xi) = |f| / (omega_fluid |b_perp|) the fluid-frame pitch factor.
//
// What bounds it: arithmetic. The state has 8 components, but this is the
// widest right-hand side of all the families: beside the geodesic and the
// emissivity it forms two metrics, three lowered vectors, two norms and
// the 2x2 inversion (183 flops, three sqrt, one pow and 18 divisions more
// than the thin form, ops/cuda/bounds.py; sin and cos of theta come from
// the geodesic's evaluation), six times an attempt. A ray reads 24 bytes
// and writes 28.

#include "kerr_dp45_extras.cuh"

namespace {

template <class T>
struct Stokes {
  static constexpr int kExtras = 3;
  static constexpr int kAux = 4;
  static constexpr int kMinBlocks = kSingle<T> ? 4 : 3;
  template <int Fam>
  __device__ static void eval(const T* y, Trig<T> tr, T p_t, T p_phi,
                              const Params<T>& P, const RiafParams<T>& R,
                              const T* aux, T* d) {
    static_assert(Fam == kKerr, "the Stokes transfer is Kerr-only");
    const T r = y[0], p_r = y[3], p_th = y[4];
    const T sin_th = tr.s, cos_th = tr.c;
    const Source<T> s = source<Fam>(y, cos_th, p_t, p_phi, P, R);
    const T r2 = r * r;

    // photon k^mu from the contravariant metric (E = 1, L = p_phi)
    const T sin2_f = jmax(sin_th * sin_th, Consts<T>::kSin2Floor);
    const T Sigma_i = r2 + R.a2 * cos_th * cos_th;
    const T Delta = r2 - R.two_M * r + R.a2;
    const T ra2 = r2 + R.a2;
    const T A = ra2 * ra2 - R.a2 * Delta * sin2_f;
    const T SD = Sigma_i * Delta;
    const T gi_tt = -A / SD;
    const T gi_tphi = -R.two_Ma * r / SD;
    const T gi_phiphi = (Delta - R.a2 * sin2_f) / (SD * sin2_f);
    const T k0 = gi_tt * -T(1.0) + gi_tphi * p_phi;
    const T k1 = Delta / Sigma_i * p_r;
    const T k2 = T(1.0) / Sigma_i * p_th;
    const T k3 = gi_tphi * -T(1.0) + gi_phiphi * p_phi;

    // covariant metric (polarization.covariant_metric)
    const T sin2 = sin_th * sin_th;
    const T Sigma = r2 + R.a2 * (cos_th * cos_th);
    const T g_tt = -(T(1.0) - R.two_M * r / Sigma);
    const T g_tphi = -R.two_Ma * r * sin2 / Sigma;
    const T g_rr = Sigma / Delta;
    const T g_thth = Sigma;
    const T g_phiphi = (r2 + R.a2 + R.two_Ma2 * r * sin2 / Sigma) * sin2;

    // the flow's 4-velocity u = (u0, 0, 0, u3)
    const T om_k = R.kep_num / (pow_(r, T(1.5)) + R.kep_add);
    const T om_z = -g_tphi / jmax(g_phiphi, T(1e-30));
    const T tl_k = -(g_tt + T(2.0) * om_k * g_tphi + om_k * om_k * g_phiphi);
    const T om = tl_k > T(1e-3) ? om_k : om_z;
    const T tl = -(g_tt + T(2.0) * om * g_tphi + om * om * g_phiphi);
    const T u0 = T(1.0) / sqrt_(jmax(tl, T(1e-12)));
    const T u3 = u0 * om;

    // the field direction b = (0, b1, b2, b3)
    T b1 = T(0.0), b2 = T(0.0), b3 = T(0.0);
    if (R.field == kVertical) {
      b1 = cos_th;
      b2 = -sin_th / jmax(r, T(1e-6));
    } else if (R.field == kToroidal) {
      b3 = R.flow_sign;
    } else {
      b1 = T(1.0);
    }

    // lowered u, k, b
    const T ul0 = g_tt * u0 + g_tphi * u3;
    const T ul3 = g_tphi * u0 + g_phiphi * u3;
    const T kl0 = g_tt * k0 + g_tphi * k3;
    const T kl1 = g_rr * k1;
    const T kl2 = g_thth * k2;
    const T kl3 = g_tphi * k0 + g_phiphi * k3;
    const T bl0 = g_tphi * b3;
    const T bl1 = g_rr * b1;
    const T bl2 = g_thth * b2;
    const T bl3 = g_phiphi * b3;

    // f^mu = eps^{mu nu rho sigma} u_nu k_rho b_sigma / sqrt(-det g): the
    // twelve terms with nu in {t, phi}, each divided by sqrt(-det g) and
    // summed from zero in the order of the plain loop's contraction
    // (polarization.py _PERMS, itertools.permutations order); the other
    // twelve add zeros, which change no sum.
    const T sqrtg = jmax(Sigma * abs_(sin_th), T(1e-12));
    const T f0 = T(0.0) + ul3 * kl1 * bl2 / sqrtg + -ul3 * kl2 * bl1 / sqrtg;
    const T f1 = T(0.0) + -ul0 * kl2 * bl3 / sqrtg + ul0 * kl3 * bl2 / sqrtg +
                 -ul3 * kl0 * bl2 / sqrtg + ul3 * kl2 * bl0 / sqrtg;
    const T f2 = T(0.0) + ul0 * kl1 * bl3 / sqrtg + -ul0 * kl3 * bl1 / sqrtg +
                 ul3 * kl0 * bl1 / sqrtg + -ul3 * kl1 * bl0 / sqrtg;
    const T f3 = T(0.0) + -ul0 * kl1 * bl2 / sqrtg + ul0 * kl2 * bl1 / sqrtg;

    // the fluid-frame pitch factor sin(xi) = |f| / (omega_fluid |b_perp|)
    const T omega_fluid = -(kl0 * u0 + kl3 * u3);
    const T bu = bl0 * u0 + bl3 * u3;
    const T bp0 = bu * u0, bp3 = b3 + bu * u3;
    const T b_sq = (g_tt * bp0 + g_tphi * bp3) * bp0 + g_rr * b1 * b1 +
                   g_thth * b2 * b2 + (g_tphi * bp0 + g_phiphi * bp3) * bp3;
    const T f_sq = (g_tt * f0 + g_tphi * f3) * f0 + g_rr * f1 * f1 +
                   g_thth * f2 * f2 + (g_tphi * f0 + g_phiphi * f3) * f3;
    const T b_norm = sqrt_(jmax(b_sq, T(1e-30)));
    const T f_norm = sqrt_(jmax(f_sq, T(0.0)));
    const T sin_xi =
        jclip(f_norm / jmax(omega_fluid * b_norm, T(1e-30)), T(0.0), T(1.0));

    // the element's Walker-Penrose constant (A - iB)(r - i a cos theta)
    const T wp_a =
        (k0 * f1 - k1 * f0) + R.a * sin2 * (k1 * f3 - k3 * f1);
    const T wp_b = sin_th * ((r2 + R.a2) * (k3 * f2 - k2 * f3) -
                                 R.a * (k0 * f2 - k2 * f0));
    const T ac = R.a * cos_th;
    const T kappa1 = wp_a * r - wp_b * ac;
    const T kappa2 = -(wp_b * r + wp_a * ac);

    // inverted at the camera: f_obs = x e1 + yv e2, chi = atan2(-x, yv)
    const T k11 = aux[0], k21 = aux[1], k12 = aux[2], k22 = aux[3];
    const T det = k11 * k22 - k12 * k21;
    const bool ok = abs_(det) > T(1e-20);
    const T det_s = ok ? det : T(1.0);
    const T x = (kappa1 * k22 - kappa2 * k12) / det_s;
    const T yv = (kappa2 * k11 - kappa1 * k21) / det_s;
    const T n2 = x * x + yv * yv;
    const bool good = ok && (n2 > T(1e-24));
    const T n2_s = good ? n2 : T(1.0);
    const T cos2 = (yv * yv - x * x) / n2_s;
    const T sin2chi = -T(2.0) * x * yv / n2_s;
    const T amp = good ? R.p0 * (sin_xi * sin_xi) * s.w * s.j : T(0.0);
    d[0] = s.em;
    d[1] = amp * cos2;
    d[2] = amp * sin2chi;
  }
};

// The one functor of this source (form 0, variant 0).
struct Forms {
  template <class Fn>
  int operator()(int form, int variant, Fn&& fn) const {
    if (form != 0 || variant != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return fn(Tag<Stokes<Real>>());
  }
};

}  // namespace

extern "C" {

// Launches the Stokes form of the extras kernel for `call` (an ExtrasCall
// of Real with four aux pointers) and the RiafParams of Real at `riaf`;
// returns a cudaError_t (0 on success).
int LPT_ENTRY(lpt_kerr_dp45_stokes)(const void* call, const void* riaf) {
  const ExtrasCall<Real>& C = *static_cast<const ExtrasCall<Real>*>(call);
  for (int k = 0; k < Stokes<Real>::kAux; ++k)
    if (C.aux[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run_entry(call, riaf, Forms());
}

// The resources of the Stokes instance on the current card into
// out[0..3] (describe in kerr_dp45_extras.cuh); a cudaError_t.
int LPT_ENTRY(lpt_kerr_dp45_stokes_describe)(int form, int variant,
                                              int* out) {
  return describe_entry(form, variant, out, Forms());
}

}  // extern "C"
