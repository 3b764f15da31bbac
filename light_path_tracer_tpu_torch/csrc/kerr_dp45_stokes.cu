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
// vanish for every field; the rest are written out. Its Walker-Penrose
// constant is inverted through the ray's four camera-side constants
// (aux: kappa(e1), kappa(e2), read once into registers), which gives
// cos 2chi and sin 2chi by algebra alone, and
//   dI = g^p j, dQ = p0 sin^2(xi) g^p j cos 2chi, dU = ... sin 2chi
// with sin(xi) = |f| / (omega_fluid |b_perp|) the fluid-frame pitch factor.
//
// What bounds it: arithmetic. The state has 8 components, but this is the
// widest right-hand side of all the families: beside the geodesic and the
// emissivity it forms two metrics, three lowered vectors, two norms and
// the 2x2 inversion (about 230 flops, three sqrt, one pow and a dozen
// divisions more than the thin form), six times an attempt. A ray reads
// 24 bytes and writes 28.

#include "kerr_dp45_extras.cuh"

namespace {

struct Stokes {
  static constexpr int kExtras = 3;
  static constexpr int kAux = 4;
  __device__ static void eval(const float* y, float p_t, float p_phi,
                              const Params&, const RiafParams& R,
                              const float* aux, float* d) {
    const float r = y[0], th = y[1], p_r = y[3], p_th = y[4];
    const Source s = source(y, p_t, p_phi, R);
    const float sin_th = sinf(th), cos_th = cosf(th);
    const float r2 = r * r;

    // photon k^mu from the contravariant metric (E = 1, L = p_phi)
    const float sin2_f = jmax(sin_th * sin_th, kSin2Floor);
    const float Sigma_i = r2 + R.a2 * cos_th * cos_th;
    const float Delta = r2 - R.two_M * r + R.a2;
    const float ra2 = r2 + R.a2;
    const float A = ra2 * ra2 - R.a2 * Delta * sin2_f;
    const float SD = Sigma_i * Delta;
    const float gi_tt = -A / SD;
    const float gi_tphi = -R.two_Ma * r / SD;
    const float gi_phiphi = (Delta - R.a2 * sin2_f) / (SD * sin2_f);
    const float k0 = gi_tt * -1.0f + gi_tphi * p_phi;
    const float k1 = Delta / Sigma_i * p_r;
    const float k2 = 1.0f / Sigma_i * p_th;
    const float k3 = gi_tphi * -1.0f + gi_phiphi * p_phi;

    // covariant metric (polarization.covariant_metric)
    const float sin2 = sin_th * sin_th;
    const float Sigma = r2 + R.a2 * (cos_th * cos_th);
    const float g_tt = -(1.0f - R.two_M * r / Sigma);
    const float g_tphi = -R.two_Ma * r * sin2 / Sigma;
    const float g_rr = Sigma / Delta;
    const float g_thth = Sigma;
    const float g_phiphi = (r2 + R.a2 + R.two_Ma2 * r * sin2 / Sigma) * sin2;

    // the flow's 4-velocity u = (u0, 0, 0, u3)
    const float om_k = R.kep_num / (powf(r, 1.5f) + R.kep_add);
    const float om_z = -g_tphi / jmax(g_phiphi, 1e-30f);
    const float tl_k = -(g_tt + 2.0f * om_k * g_tphi + om_k * om_k * g_phiphi);
    const float om = tl_k > 1e-3f ? om_k : om_z;
    const float tl = -(g_tt + 2.0f * om * g_tphi + om * om * g_phiphi);
    const float u0 = 1.0f / sqrtf(jmax(tl, 1e-12f));
    const float u3 = u0 * om;

    // the field direction b = (0, b1, b2, b3)
    float b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
    if (R.field == kVertical) {
      b1 = cos_th;
      b2 = -sin_th / jmax(r, 1e-6f);
    } else if (R.field == kToroidal) {
      b3 = R.flow_sign;
    } else {
      b1 = 1.0f;
    }

    // lowered u, k, b
    const float ul0 = g_tt * u0 + g_tphi * u3;
    const float ul3 = g_tphi * u0 + g_phiphi * u3;
    const float kl0 = g_tt * k0 + g_tphi * k3;
    const float kl1 = g_rr * k1;
    const float kl2 = g_thth * k2;
    const float kl3 = g_tphi * k0 + g_phiphi * k3;
    const float bl0 = g_tphi * b3;
    const float bl1 = g_rr * b1;
    const float bl2 = g_thth * b2;
    const float bl3 = g_phiphi * b3;

    // f^mu = eps^{mu nu rho sigma} u_nu k_rho b_sigma / sqrt(-det g): the
    // twelve terms with nu in {t, phi}
    const float inv_sqrtg = 1.0f / jmax(Sigma * fabsf(sin_th), 1e-12f);
    const float f0 = ul3 * (kl1 * bl2 - kl2 * bl1) * inv_sqrtg;
    const float f1 = (ul0 * (kl3 * bl2 - kl2 * bl3) +
                      ul3 * (kl2 * bl0 - kl0 * bl2)) * inv_sqrtg;
    const float f2 = (ul0 * (kl1 * bl3 - kl3 * bl1) +
                      ul3 * (kl0 * bl1 - kl1 * bl0)) * inv_sqrtg;
    const float f3 = ul0 * (kl2 * bl1 - kl1 * bl2) * inv_sqrtg;

    // the fluid-frame pitch factor sin(xi) = |f| / (omega_fluid |b_perp|)
    const float omega_fluid = -(kl0 * u0 + kl3 * u3);
    const float bu = bl0 * u0 + bl3 * u3;
    const float bp0 = bu * u0, bp3 = b3 + bu * u3;
    const float b_sq = (g_tt * bp0 + g_tphi * bp3) * bp0 + g_rr * b1 * b1 +
                       g_thth * b2 * b2 + (g_tphi * bp0 + g_phiphi * bp3) * bp3;
    const float f_sq = (g_tt * f0 + g_tphi * f3) * f0 + g_rr * f1 * f1 +
                       g_thth * f2 * f2 + (g_tphi * f0 + g_phiphi * f3) * f3;
    const float b_norm = sqrtf(jmax(b_sq, 1e-30f));
    const float f_norm = sqrtf(jmax(f_sq, 0.0f));
    const float sin_xi =
        jclip(f_norm / jmax(omega_fluid * b_norm, 1e-30f), 0.0f, 1.0f);

    // the element's Walker-Penrose constant (A - iB)(r - i a cos theta)
    const float wp_a =
        (k0 * f1 - k1 * f0) + R.a * sin2 * (k1 * f3 - k3 * f1);
    const float wp_b = sin_th * ((r2 + R.a2) * (k3 * f2 - k2 * f3) -
                                 R.a * (k0 * f2 - k2 * f0));
    const float ac = R.a * cos_th;
    const float kappa1 = wp_a * r - wp_b * ac;
    const float kappa2 = -(wp_b * r + wp_a * ac);

    // inverted at the camera: f_obs = x e1 + yv e2, chi = atan2(-x, yv)
    const float k11 = aux[0], k21 = aux[1], k12 = aux[2], k22 = aux[3];
    const float det = k11 * k22 - k12 * k21;
    const bool ok = fabsf(det) > 1e-20f;
    const float det_s = ok ? det : 1.0f;
    const float x = (kappa1 * k22 - kappa2 * k12) / det_s;
    const float yv = (kappa2 * k11 - kappa1 * k21) / det_s;
    const float n2 = x * x + yv * yv;
    const bool good = ok && (n2 > 1e-24f);
    const float n2_s = good ? n2 : 1.0f;
    const float cos2 = (yv * yv - x * x) / n2_s;
    const float sin2chi = -2.0f * x * yv / n2_s;
    const float amp = good ? R.p0 * (sin_xi * sin_xi) * s.w * s.j : 0.0f;
    d[0] = s.em;
    d[1] = amp * cos2;
    d[2] = amp * sin2chi;
  }
};

}  // namespace

extern "C" {

// Launches the Stokes form of the extras kernel for `call` (an ExtrasCall
// with four aux pointers) and the RiafParams at `riaf`; returns a
// cudaError_t (0 on success).
int lpt_kerr_dp45_stokes(const void* call, const void* riaf) {
  const ExtrasCall& C = *static_cast<const ExtrasCall*>(call);
  Prepared K;
  cudaError_t err;
  if (!begin(C, riaf, &K, &err)) return static_cast<int>(err);
  for (int k = 0; k < Stokes::kAux; ++k)
    if (C.aux[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  launch<Stokes>(C, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
