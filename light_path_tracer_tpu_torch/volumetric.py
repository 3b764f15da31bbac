"""Volumetric radiative-transfer rendering (RIAF / hot-flow images).

The counterpart of `light_path_tracer_tpu.volumetric`: the single-band
still image (`render_volumetric`, optically thin or self-absorbed), the
multi-frequency spectral image (`render_volumetric_spectrum`), the flare
movie (`render_volumetric_movie`) and the photon-ring order decomposition
(`render_volumetric_decomposed`); the polarized image is in
`polarization.py`. The emission rides the adaptive DP45 loop as
error-controlled extra state components:

    thin:      dI/dlambda = g^p j_rest(r, theta)
    absorbed:  dI/dlambda = exp(-tau) g^p j_rest,  dtau/dlambda = chi
    spectral:  d tau_hat = alpha0 j g^(q-1),
               dI_i = f_i^-s j g^(3+s) exp(-f_i^(1-q) tau_hat)
    movie:     dt = g^tt p_t + g^tphi p_phi,
               dI_k = [exp(-tau)] g^p (j + blob(t_k - t))
    orders:    dm = N(cos theta; 0, 0.03) |sin theta| |p_theta| / Sigma,
               dI_n = [exp(-tau)] g^p j  where floor(m) = n

with g the redshift of a Keplerian circular flow (ZAMO inside the photon
region), or of a radial outflow in the jet profile; the JAX module's
docstring derives each. In a charged (Kerr-Newman) spacetime the flow
reads the charge as the JAX package's does: W = 2Mr - Q^2 in the t-phi
block, Q^2 in Delta, and the charged Keplerian Omega. The emissivity
profiles are the torus, the power law, the smoothed shell and the bipolar
jet cone.

The trace runs on the tensors' device: the hand-written CUDA kernel
(`ops/cuda/volumetric_kernel.py`, `csrc/kerr_dp45_extras.cu`) on a CUDA
device, by default inside the two-pass straggler drivers, and the plain
PyTorch loop (`ops/kerr_trace.py`) on the CPU. The transfer functions
below are the plain loop's; each carries the description (`.kernel`) from
which the kernel evaluates the same function in registers.

A boosted camera aberrates the grids (the JAX package applies no
Doppler factor to the hot flow). Not ported yet (it raises, see ROADMAP.md
Queue 1): the multi-device `mesh=` path.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera, disk
from light_path_tracer_tpu_torch.disk import (_tone_map,
                                              covariant_tphi_components,
                                              keplerian_omega)
from light_path_tracer_tpu_torch.ops.batch import _backend
from light_path_tracer_tpu_torch.ops.kerr_trace import CAPTURED, INVALID
from light_path_tracer_tpu_torch.operands import kernel_operand as _k
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer

__all__ = ["RIAFConfig", "KernelTransfer", "make_transfer_fns",
           "make_emission_fn", "make_spectral_transfer",
           "make_movie_transfer", "make_order_transfer",
           "render_volumetric", "render_volumetric_spectrum",
           "render_volumetric_movie", "render_volumetric_decomposed"]


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md, "
        f"Queue 1)")


@dataclasses.dataclass(frozen=True)
class RIAFConfig:
    """Hot-flow emission model (rest-frame emissivity + flow field): the
    JAX package's RIAFConfig, field for field."""

    profile: str = "torus"         # "torus" | "powerlaw" | "shell" | "jet"
    r_peak: float = 4.5            # torus center / powerlaw pivot [M]
    sigma_r: float = 1.5           # torus radial Gaussian width [M]
    h_cos: float = 0.3             # vertical Gaussian width in cos(theta)
    index: float = -1.5            # powerlaw exponent
    shell_in: float = 0.0          # shell inner radius [M]
    shell_out: float = 0.0         # shell outer radius [M]
    edge_width: float = 0.2        # shell / jet-base edge smoothing [M]
    g_power: float = 3.0           # redshift weight exponent p = 3 + s
    prograde: bool = True          # flow rotation sense
    tone_map: str = "sqrt"         # "linear" | "sqrt" | "asinh"
    alpha0: float = 0.0            # opacity scale [1/M]; 0 = optically thin
    opacity_index: float = 0.0     # q in alpha_nu ~ nu^-q (spectral only)
    # Orbiting hot-spot blob (flare movies): a Gaussian emissivity blob
    # of peak spot_amp co-rotating with the Keplerian flow at spot_r.
    spot_amp: float = 0.0
    spot_r: float = 6.0
    spot_sigma: float = 1.0
    spot_phase: float = 0.0
    # Relativistic jet (profile="jet"): a bipolar hollow cone about
    # |cos theta| = jet_cos with a ZAMO-frame radial outflow jet_beta.
    jet_cos: float = 0.9
    jet_sigma: float = 0.06
    jet_beta: float = 0.0
    jet_r_base: float = 2.0


@dataclasses.dataclass(frozen=True)
class KernelTransfer:
    """What a transfer function computes, for the CUDA kernel to compute
    it too, for `riaf` in `metric`: `kind` is "emission", "absorption",
    "spectral" (with the band frequencies `freqs`), "movie" (with the
    frame `times`), "order" (with `n_orders` buckets) or "stokes" (with
    the magnetic `field` geometry and the polarization fraction `p0`)."""

    kind: str
    metric: object
    riaf: RIAFConfig
    freqs: tuple = ()
    times: tuple = ()
    n_orders: int = 0
    field: str = ""
    p0: float = 0.0

    def constants(self) -> dict:
        """The constants the kernel evaluates the closures below with,
        each formed in double as the JAX closures' Python floats are
        (the kernel's wrapper rounds each once to float32 for the
        float32 instances and passes it unrounded to the float64 ones); c and
        band_scale are per band, empty for the single-band forms; the
        spot_* constants are the movie's blob, the order_* ones the
        crossing bump of the order decomposition."""
        riaf = self.riaf
        M, a = float(self.metric.M), float(self.metric.a)
        Q = _charge(self.metric)
        sign = 1.0 if riaf.prograde else -1.0
        c, band_scale, floor = (spectral_constants(riaf, self.freqs)
                                if self.freqs else ((), (), 0.0))
        return dict(
            two_M=2.0 * M, a=a, a2=a * a,
            # the charged Keplerian +-x / (r^2 +- a x) takes +-1 and +-a
            kep_num=sign if Q else sign * float(np.sqrt(M)),
            kep_add=sign * a if Q else sign * (a * float(np.sqrt(M))),
            r_peak=riaf.r_peak, two_sig_r2=_two_sq(riaf.sigma_r),
            two_h2=_two_sq(riaf.h_cos), index=riaf.index,
            shell_in=riaf.shell_in, shell_out=riaf.shell_out,
            edge_width=riaf.edge_width, jet_cos=riaf.jet_cos,
            two_jet_sig2=_two_sq(riaf.jet_sigma),
            jet_r_base=riaf.jet_r_base, jet_beta=float(riaf.jet_beta),
            jet_gamma=_jet_gamma(riaf.jet_beta), g_power=riaf.g_power,
            alpha0=riaf.alpha0, q_minus_1=riaf.opacity_index - 1.0,
            tau_floor=floor, c=c, band_scale=band_scale,
            spot_amp=riaf.spot_amp, spot_phase=riaf.spot_phase,
            spot_omega=keplerian_omega(M, a, riaf.spot_r, riaf.prograde,
                                       Q=Q),
            spot_r=riaf.spot_r, spot_r2=riaf.spot_r * riaf.spot_r,
            two_spot_sig2=_two_sq(riaf.spot_sigma),
            order_norm=_ORDER_NORM, order_inv_two_sig2=_ORDER_INV_TWO_SIG2,
            two_Ma=2.0 * M * a, two_Ma2=2.0 * M * a * a,
            flow_sign=sign, p0=float(self.p0))


# Width of the equatorial-crossing bump in cos(theta) of the order
# decomposition: the winding coordinate m integrates a unit-mass Gaussian
# each time the ray sweeps through the plane. Small against the torus's
# vertical extent (h_cos ~ 0.3), large enough for the error controller to
# resolve the bump in a few steps. The norm and exponent scale are formed
# in double.
_ORDER_SIGMA = 0.03
_ORDER_NORM = float(1.0 / (_ORDER_SIGMA * np.sqrt(2.0 * np.pi)))
_ORDER_INV_TWO_SIG2 = float(1.0 / (2.0 * _ORDER_SIGMA ** 2))


def _two_sq(width: float) -> float:
    """2 width^2 of a Gaussian profile, in double."""
    return 2.0 * width ** 2


def _jet_gamma(beta: float) -> float:
    """The jet's Lorentz factor, in double as the JAX closure forms it."""
    beta = float(beta)
    return float(1.0 / np.sqrt(max(1.0 - beta * beta, 1e-12)))


def _charge(metric) -> float:
    """The metric's charge Q as a Python float (0 for Kerr)."""
    return float(getattr(metric, "Q", 0.0))


def _scene_metric(scene: SceneConfig):
    """Kerr or Kerr-Newman of the scene (disk._scene_metric)."""
    return disk._scene_metric(scene)


@functools.lru_cache(maxsize=64)
def _profile_fns(metric, riaf: RIAFConfig):
    """(j_rest(r, c), g(y5, p_t, p_phi)): the rest-frame emissivity at
    (r, cos theta) and the emitter redshift clipped to [0, 10] (circular
    flow, or the radial outflow for the jet), batched over tensors. The
    same operations in the same order as the JAX closures, with every
    Python-float constant formed in double and rounded once. W and Delta
    come from the metric's charge hooks (2Mr - Q^2 and Delta + Q^2 for
    Kerr-Newman), Omega_K from the charged form where Q != 0."""
    M = float(metric.M)
    a = float(metric.a)
    Q = _charge(metric)

    def _j_rest(r, c):
        if riaf.profile == "torus":
            return torch.exp(-(r - riaf.r_peak) ** 2
                             / _k(_two_sq(riaf.sigma_r), r)
                             - c * c / _k(_two_sq(riaf.h_cos), r))
        if riaf.profile == "powerlaw":
            return ((torch.clamp(r, min=1e-3) / _k(riaf.r_peak, r))
                    ** _k(riaf.index, r)
                    * torch.exp(-c * c / _k(_two_sq(riaf.h_cos), r)))
        if riaf.profile == "jet":
            c_abs = torch.abs(c)
            return (torch.exp(-(c_abs - riaf.jet_cos) ** 2
                              / _k(_two_sq(riaf.jet_sigma), r))
                    * (torch.clamp(r, min=1e-3) / _k(riaf.r_peak, r))
                    ** _k(riaf.index, r)
                    * torch.sigmoid((r - riaf.jet_r_base)
                                    / _k(riaf.edge_width, r)))
        return (torch.sigmoid((r - riaf.shell_in) / _k(riaf.edge_width, r))
                * torch.sigmoid((riaf.shell_out - r)
                                / _k(riaf.edge_width, r)))

    def _g_clipped(y5, p_t, p_phi):
        """Circular-emitter redshift off the plane: Keplerian where that
        orbit is timelike, ZAMO inside."""
        r, th = y5[0], y5[1]
        c = torch.cos(th)
        s2 = torch.clamp(1.0 - c * c, min=1e-12)
        W = metric._two_M_r(r, M)
        Delta = metric._Delta_b(r, M, a)
        ra2 = r * r + a * a
        A = ra2 * ra2 - a * a * Delta * s2
        g_tt, g_tph, g_pp = covariant_tphi_components(metric, r, c)
        om_k = keplerian_omega(M, a, r, riaf.prograde, Q=Q)
        om_z = a * W / torch.clamp(A, min=1e-30)

        def timelike(om):
            return -(g_tt + 2.0 * om * g_tph + om * om * g_pp)

        om = torch.where(timelike(om_k) > 1e-3, om_k, om_z)
        den = torch.clamp(timelike(om), min=1e-12)
        xi = p_phi / torch.clamp(-p_t, min=1e-30)
        g = torch.sqrt(den) / torch.clamp(1.0 - om * xi, min=1e-3)
        return torch.clamp(g, 0.0, 10.0)

    def _g_jet(y5, p_t, p_phi):
        """Redshift of an emitter moving radially outward at jet_beta in
        the ZAMO frame: 1/g = Gamma [(1 - omega xi) / alpha_lapse
        + beta sqrt(Delta / Sigma) p_r / E] with the traced p_r."""
        r, th = y5[0], y5[1]
        p_r = y5[3]
        c = torch.cos(th)
        s2 = torch.clamp(1.0 - c * c, min=1e-12)
        W = metric._two_M_r(r, M)
        Delta = torch.clamp(metric._Delta_b(r, M, a), min=1e-12)
        Sigma = torch.clamp(r * r + a * a * c * c, min=1e-12)
        ra2 = r * r + a * a
        A = torch.clamp(ra2 * ra2 - a * a * Delta * s2, min=1e-30)
        om = a * W / A
        alpha_lapse = torch.sqrt(Sigma * Delta / A)
        beta = float(riaf.jet_beta)
        gamma = _jet_gamma(beta)
        e_inv = torch.clamp(-p_t, min=1e-30)
        xi = p_phi / e_inv
        inv_g = gamma * ((1.0 - om * xi)
                         / torch.clamp(alpha_lapse, min=1e-6)
                         + beta * torch.sqrt(Delta / Sigma)
                         * p_r / e_inv)
        g = 1.0 / torch.clamp(inv_g, min=0.1)
        return torch.clamp(g, 0.0, 10.0)

    if riaf.profile == "jet":
        return _j_rest, _g_jet
    return _j_rest, _g_clipped


def _validate(metric, riaf: RIAFConfig):
    if getattr(metric, "eps3", 0.0):
        raise ValueError("volumetric mode is not wired for "
                         "Johannsen-Psaltis (eps3 != 0): the flow "
                         "field (Keplerian Omega, circular-emitter "
                         "redshift) is a Kerr/charged closed form")
    if riaf.profile not in ("torus", "powerlaw", "shell", "jet"):
        raise ValueError(f"profile must be 'torus', 'powerlaw', "
                         f"'shell' or 'jet', got {riaf.profile!r}")
    if not 0.0 <= riaf.jet_beta < 1.0:
        raise ValueError(f"jet_beta must be in [0, 1), got "
                         f"{riaf.jet_beta}")
    if riaf.profile == "shell" and not riaf.shell_out > riaf.shell_in:
        raise ValueError("shell profile needs shell_out > shell_in")
    if riaf.alpha0 < 0.0:
        raise ValueError(f"alpha0 must be >= 0, got {riaf.alpha0}")


@functools.lru_cache(maxsize=64)
def make_transfer_fns(metric, riaf: RIAFConfig):
    """(emission_fn, absorption_fn) of the single-band transfer, cached
    per (metric, config).

    emission_fn(y5, p_t, p_phi) -> g^p j_rest(r, theta); absorption_fn
    -> the invariant opacity alpha0 j_rest / max(g, 0.1), None when
    alpha0 == 0 (optically thin). g_power == 0 is the pure-geometry
    mode: no redshift anywhere, chi = alpha0 j_rest.
    """
    _validate(metric, riaf)
    _j_rest, _g_clipped = _profile_fns(metric, riaf)

    if riaf.g_power == 0.0:
        def emission_fn(y5, p_t, p_phi):
            return _j_rest(y5[0], torch.cos(y5[1]))

        def absorption_fn(y5, p_t, p_phi):
            return riaf.alpha0 * _j_rest(y5[0], torch.cos(y5[1]))
    else:
        def emission_fn(y5, p_t, p_phi):
            j = _j_rest(y5[0], torch.cos(y5[1]))
            g = _g_clipped(y5, p_t, p_phi)
            return j * g ** _k(riaf.g_power, g)

        def absorption_fn(y5, p_t, p_phi):
            j = _j_rest(y5[0], torch.cos(y5[1]))
            g = torch.clamp(_g_clipped(y5, p_t, p_phi), min=0.1)
            return riaf.alpha0 * j / g

    emission_fn.kernel = KernelTransfer("emission", metric, riaf)
    absorption_fn.kernel = KernelTransfer("absorption", metric, riaf)
    return emission_fn, (absorption_fn if riaf.alpha0 > 0.0 else None)


def make_emission_fn(metric, riaf: RIAFConfig):
    """The emission half of make_transfer_fns (same cached object)."""
    return make_transfer_fns(metric, riaf)[0]


def spectral_constants(riaf: RIAFConfig, freqs: tuple):
    """(c_i = f_i^(1-q), band_scale_i = f_i^-s, tau_hat floor) of the
    spectral transfer, in double: band i's optical depth is c_i tau_hat
    and its emission scale band_scale_i, with s = g_power - 3 and
    q = opacity_index."""
    s = riaf.g_power - 3.0
    q = riaf.opacity_index
    c = tuple(float(f) ** (1.0 - q) for f in freqs)
    band_scale = tuple(float(f) ** (-s) for f in freqs)
    return c, band_scale, -30.0 / max(max(c), 1.0)


@functools.lru_cache(maxsize=64)
def make_spectral_transfer(metric, riaf: RIAFConfig, freqs: tuple):
    """transfer_fn(y, p_t, p_phi) -> (d tau_hat, d I_1, ..., d I_n) of the
    multi-frequency self-absorbed transfer, all bands in one trace: one
    reduced optical depth tau_hat serves every band (tau_i = f_i^(1-q)
    tau_hat). The tau_hat floor -30 / max(max c, 1) bounds exp(+c|tau|)
    on RK stage probes only; accepted states never clip."""
    if not freqs or any(f <= 0 for f in freqs):
        raise ValueError(f"freqs must be positive, got {freqs!r}")
    make_transfer_fns(metric, riaf)               # validates the config
    _j_rest, _g_clipped = _profile_fns(metric, riaf)
    q = riaf.opacity_index
    c, band_scale, floor = spectral_constants(riaf, freqs)

    def transfer_fn(y, p_t, p_phi):
        j = _j_rest(y[0], torch.cos(y[1]))
        if riaf.g_power == 0.0:
            em = j
            chi_hat = riaf.alpha0 * j
        else:
            g = _g_clipped(y[:5], p_t, p_phi)
            em = j * g ** _k(riaf.g_power, g)
            chi_hat = (riaf.alpha0 * j
                       * torch.clamp(g, min=0.1) ** _k(q - 1.0, g))
        tau_hat = torch.clamp(y[5], min=floor)
        d_i = tuple(bs * em * torch.exp(-ci * tau_hat)
                    for bs, ci in zip(band_scale, c))
        return (chi_hat, *d_i)

    transfer_fn.kernel = KernelTransfer("spectral", metric, riaf,
                                        tuple(float(f) for f in freqs))
    return transfer_fn


def _weights(riaf, _j_rest, _g_clipped, y, p_t, p_phi):
    """(j, w, chi) at state y: the rest-frame emissivity, the redshift
    weight g^p and the invariant opacity alpha0 j / max(g, 0.1); w = 1
    and chi = alpha0 j in the pure-geometry mode (g_power == 0)."""
    j = _j_rest(y[0], torch.cos(y[1]))
    if riaf.g_power == 0.0:
        return j, 1.0, riaf.alpha0 * j
    g = _g_clipped(y[:5], p_t, p_phi)
    return (j, g ** _k(riaf.g_power, g),
            riaf.alpha0 * j / torch.clamp(g, min=0.1))


@functools.lru_cache(maxsize=64)
def make_movie_transfer(metric, riaf: RIAFConfig, times: tuple):
    """transfer_fn(y, p_t, p_phi) of the flare movie: every
    observer-time frame in one trace.

    Extras (t, [tau,] I_1..I_n): the coordinate time from the camera is
    an error-controlled component (dt/dlambda = metric.tdot), and frame
    k's emissivity evaluates the orbiting blob at the retarded time
    t_k - t(lambda), so each pixel sees the blob where it was when that
    pixel's light left the flow. The blob is a flat-embedding Gaussian
    of peak spot_amp co-rotating with the Keplerian flow at spot_r (the
    base flow's redshift is the blob's Doppler). With alpha0 > 0 the
    stationary base flow absorbs too (shared tau, the blob optically
    thin) and the extras gain the tau component.
    """
    if riaf.spot_amp < 0.0:
        raise ValueError(f"spot_amp must be >= 0, got {riaf.spot_amp}")
    if not times:
        raise ValueError("times must be non-empty")
    make_transfer_fns(metric, riaf)               # validates the config
    _j_rest, _g_clipped = _profile_fns(metric, riaf)
    om_spot = keplerian_omega(float(metric.M), float(metric.a),
                              riaf.spot_r, riaf.prograde, Q=_charge(metric))
    R = riaf.spot_r
    two_sig2 = _two_sq(riaf.spot_sigma)
    absorbing = riaf.alpha0 > 0.0

    def transfer_fn(y, p_t, p_phi):
        r, th, phi = y[0], y[1], y[2]
        # sin(theta) keeps its sign on the double-cover chart: the
        # Cartesian embedding maps (theta > pi, phi) to the same point
        # as (2 pi - theta, phi + pi).
        s = torch.sin(th)
        t = y[5]
        j, w, chi = _weights(riaf, _j_rest, _g_clipped, y, p_t, p_phi)

        def spot(t_k):
            phi_s = riaf.spot_phase + om_spot * (t_k - t)
            d2 = (r * r + R * R
                  - 2.0 * r * R * s * torch.cos(phi - phi_s))
            return riaf.spot_amp * torch.exp(-d2 / _k(two_sig2, d2))

        tdot = metric.tdot(y[:5], p_t, p_phi)
        if absorbing:
            screen = torch.exp(-torch.clamp(y[6], min=-30.0))
            return (tdot, chi, *(screen * w * (j + spot(tk))
                                 for tk in times))
        return (tdot, *(w * (j + spot(tk)) for tk in times))

    transfer_fn.kernel = KernelTransfer(
        "movie", metric, riaf, times=tuple(float(t) for t in times))
    return transfer_fn


@functools.lru_cache(maxsize=64)
def make_order_transfer(metric, riaf: RIAFConfig, n_orders: int):
    """transfer_fn(y, p_t, p_phi) of the photon-ring decomposition: the
    path emission binned by image order, all orders in one trace.

    Extras (m, [tau,] I_0..I_{N-1}). The smooth winding coordinate m
    integrates a unit-mass Gaussian bump in cos(theta) once per
    equatorial crossing,

        dm/dlambda = N(cos theta; 0, sigma) |sin theta| |p_theta| / Sigma,

    so it counts the ray's plane crossings continuously and locally.
    Emission lands in bucket floor(m), the last bucket open-ended: order
    0 is the direct image, order 1 the first lensed image, order >= 2
    the demagnified photon subrings. Absorption shares the single-band
    tau. The buckets partition the emission, so the layers sum to the
    single-band image.
    """
    if n_orders < 2:
        raise ValueError(f"n_orders must be >= 2, got {n_orders}")
    make_transfer_fns(metric, riaf)               # validates the config
    _j_rest, _g_clipped = _profile_fns(metric, riaf)
    a2 = float(metric.a) ** 2
    absorbing = riaf.alpha0 > 0.0

    def transfer_fn(y, p_t, p_phi):
        r, th = y[0], y[1]
        c = torch.cos(th)
        j, w, chi = _weights(riaf, _j_rest, _g_clipped, y, p_t, p_phi)
        em = j * w
        sigma_bl = r * r + a2 * c * c
        dm = (_ORDER_NORM * torch.exp(-c * c * _ORDER_INV_TWO_SIG2)
              * torch.abs(torch.sin(th)) * torch.abs(y[4]) / sigma_bl)
        # RK stage probes can push m slightly negative: bucket 0.
        bucket = torch.floor(torch.clamp(y[5], min=0.0))
        if absorbing:
            em = em * torch.exp(-torch.clamp(y[6], min=-30.0))
        zero = torch.zeros_like(em)
        d_i = tuple(
            torch.where(bucket == n if n < n_orders - 1 else bucket >= n,
                        em, zero)
            for n in range(n_orders))
        if absorbing:
            return (dm, chi, *d_i)
        return (dm, *d_i)

    transfer_fn.kernel = KernelTransfer("order", metric, riaf,
                                        n_orders=int(n_orders))
    return transfer_fn


def _lookups(scene, resolution, cfg, device):
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    grid = dict(psi=scene.psi, dtype=dtype, device=device,
                boost=scene.boost)
    alpha = camera.build_alpha_lookup(resolution, fov, **grid)
    theta = camera.build_theta_lookup(resolution, fov, **grid)
    return fov, alpha.reshape(-1), theta.reshape(-1)


def _two_pass_on(cfg) -> bool:
    # "auto" = on, as in the JAX package: a near-critical photon-ring
    # orbiter can grind the whole step budget.
    return cfg.two_pass if cfg.two_pass != "auto" else True


def _lambda_max(scene) -> float:
    return max(5000.0, 6.0 * scene.r_obs)


def _trace_volumetric(metric, scene, alpha, theta, emission_fn,
                      absorption_fn, cfg):
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_rays_volumetric_two_pass)
    from light_path_tracer_tpu_torch.ops.cuda.volumetric_kernel import (
        trace_rays_volumetric_cuda)
    _backend(cfg.backend, alpha)
    fn = (trace_rays_volumetric_two_pass if _two_pass_on(cfg)
          else trace_rays_volumetric_cuda)
    return fn(metric, scene.r_obs, alpha, theta, scene.theta_obs,
              emission_fn, _lambda_max(scene), cfg.max_steps,
              precision=cfg.precision, method=cfg.integrator,
              absorption_fn=absorption_fn, sat_window=cfg.sat_window)


def _trace_spectral(metric, scene, alpha, theta, transfer_fn, n_bands,
                    cfg, sat_monitor=None):
    """The spectral, movie or order trace on the tensors' device,
    through the two-pass driver unless cfg.two_pass is False; returns
    SpectralResult. sat_monitor: the extras the saturation exit watches,
    by default the n bands (extras 1..n); the movie and the order
    decomposition pass their frames or buckets, so that the bookkeeping
    components (t, the winding m, tau) are never monitored."""
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_rays_spectral_two_pass)
    from light_path_tracer_tpu_torch.ops.cuda.volumetric_kernel import (
        trace_rays_spectral_cuda)
    _backend(cfg.backend, alpha)
    fn = (trace_rays_spectral_two_pass if _two_pass_on(cfg)
          else trace_rays_spectral_cuda)
    return fn(metric, scene.r_obs, alpha, theta, scene.theta_obs,
              transfer_fn, n_bands, _lambda_max(scene), cfg.max_steps,
              precision=cfg.precision, method=cfg.integrator,
              sat_window=cfg.sat_window, sat_monitor=sat_monitor)


def _host(x, resolution=None):
    a = x.detach().cpu().numpy()
    return a.reshape(resolution) if resolution is not None else a


def render_volumetric_spectrum(scene: SceneConfig, resolution, freqs,
                               cfg: RenderConfig = RenderConfig(),
                               riaf: RIAFConfig = RIAFConfig(),
                               mesh=None, device="cuda"):
    """Multi-frequency self-absorbed images and the spectrum from one
    trace; returns (images, stats).

    freqs: observed frequencies in units of the fiducial one. images:
    (n, H, W) float32 on `device`, each band tone-mapped on its own.
    stats (NumPy, as the JAX package returns them): freqs, flux (the
    per-band image sums), mean_radius_rad (each band's emission-weighted
    angular radius), spectral_index (per-pixel -dlnI/dln nu maps between
    adjacent bands, NaN where either is dark), emission (n, H, W),
    tau_hat (H, W), captured, invalid, integrator_steps, total_rays,
    traced_rays, timings.
    """
    if mesh is not None:
        raise _not_ported("the multi-device spectral render (mesh)")
    metric = _scene_metric(scene)
    freqs = tuple(float(f) for f in freqs)
    transfer_fn = make_spectral_transfer(metric, riaf, freqs)
    timer = StageTimer(device)
    height, width = resolution

    with timer.stage("build_lookup"):
        fov, alpha, theta = _lookups(scene, resolution, cfg, device)

    with timer.stage("precompute"):
        res = _trace_spectral(metric, scene, alpha, theta, transfer_fn,
                              len(freqs), cfg)

    with timer.stage("render"):
        images = torch.stack([
            _tone_map(em, riaf.tone_map).reshape(resolution)
            for em in res.emission]).to(torch.float32)

    em = np.stack([_host(e, resolution) for e in res.emission])
    yy = (np.arange(height) - height / 2.0) * (fov[0] / height)
    xx = (np.arange(width) - width / 2.0) * (fov[1] / width)
    rad = np.hypot(yy[:, None], xx[None, :])
    flux = em.sum(axis=(1, 2))
    mean_r = (em * rad).sum(axis=(1, 2)) / np.maximum(flux, 1e-30)
    spectral_index = []
    tiny = 1e-12 * max(float(em.max()), 1e-30)
    for i in range(len(freqs) - 1):
        good = (em[i] > tiny) & (em[i + 1] > tiny)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha_map = -(np.log(em[i + 1]) - np.log(em[i])) \
                / np.log(freqs[i + 1] / freqs[i])
        spectral_index.append(np.where(good, alpha_map, np.nan))
    status = _host(res.status)
    stats = dict(
        freqs=np.asarray(freqs),
        flux=flux,
        mean_radius_rad=mean_r,
        spectral_index=spectral_index,
        emission=em,
        tau_hat=_host(res.tau_hat, resolution),
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return images, stats


def render_volumetric(scene: SceneConfig, resolution,
                      cfg: RenderConfig = RenderConfig(),
                      riaf: RIAFConfig = RIAFConfig(), mesh=None,
                      device="cuda"):
    """Volumetric hot-flow image; returns (image, stats).

    image: (H, W) float32 in [0, 1] on `device` (riaf.tone_map of the
    emission, normalised to its maximum). stats: alpha_crit, captured,
    invalid, emission (the raw (H, W) path integrals, NumPy),
    emission_total, optical_depth (H, W), tau_max, integrator_steps,
    total_rays, traced_rays, timings (build_lookup, precompute, render;
    each stage ends with the CUDA device synchronised).
    """
    if mesh is not None:
        raise _not_ported("the multi-device volumetric render (mesh)")
    metric = _scene_metric(scene)
    emission_fn, absorption_fn = make_transfer_fns(metric, riaf)
    timer = StageTimer(device)
    height, width = resolution

    with timer.stage("build_lookup"):
        _fov, alpha, theta = _lookups(scene, resolution, cfg, device)

    with timer.stage("precompute"):
        res = _trace_volumetric(metric, scene, alpha, theta, emission_fn,
                                absorption_fn, cfg)

    with timer.stage("render"):
        image = _tone_map(res.emission, riaf.tone_map).reshape(
            resolution).to(torch.float32)

    status = _host(res.status)
    emission = _host(res.emission)
    tau = _host(res.optical_depth, resolution)
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device),
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        emission=emission.reshape(resolution),
        emission_total=float(emission.sum()),
        optical_depth=tau,
        tau_max=float(tau.max()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return image, stats



def _extras_trace(metric, scene, resolution, cfg, device, timer,
                  transfer_fn, n_items: int, absorbing: bool):
    """The movie's and the decomposition's shared trace: extras
    (bookkeeping, [tau,] item_1..item_n) through _trace_spectral with
    the saturation exit watching the items only. Returns (fov, res,
    items, tau on the host)."""
    with timer.stage("build_lookup"):
        fov, alpha, theta = _lookups(scene, resolution, cfg, device)
    with timer.stage("precompute"):
        n_extra_bands = n_items + (1 if absorbing else 0)
        first = 1 + (1 if absorbing else 0)
        res = _trace_spectral(
            metric, scene, alpha, theta, transfer_fn, n_extra_bands, cfg,
            sat_monitor=tuple(range(first, 1 + n_extra_bands)))
    items = res.emission[1:] if absorbing else res.emission
    tau = (_host(res.emission[0], resolution) if absorbing
           else np.zeros(resolution))
    return fov, res, items, tau


def render_volumetric_movie(scene: SceneConfig, resolution, times,
                            cfg: RenderConfig = RenderConfig(),
                            riaf: RIAFConfig = RIAFConfig(), mesh=None,
                            device="cuda"):
    """Flare movie: every observer-time frame from one geodesic trace;
    returns (frames, stats).

    times: observer coordinate times [M] of the frames (the blob orbits
    with period 2 pi / Omega_K(spot_r)). frames: (n, H, W) float32 on
    `device`, tone-mapped on a common scale so that brightness is
    comparable across frames. stats (NumPy): times, light_curve (the
    per-frame integrated flux), emission (n, H, W), optical_depth,
    t_max (the largest coordinate time any ray reached), spot_period,
    captured, invalid, integrator_steps, total_rays, traced_rays,
    timings.
    """
    if mesh is not None:
        raise _not_ported("the multi-device movie render (mesh)")
    metric = _scene_metric(scene)
    times = tuple(float(t) for t in times)
    transfer_fn = make_movie_transfer(metric, riaf, times)
    timer = StageTimer(device)
    height, width = resolution
    _fov, res, bands, tau = _extras_trace(
        metric, scene, resolution, cfg, device, timer, transfer_fn,
        len(times), riaf.alpha0 > 0.0)

    with timer.stage("render"):
        peak = torch.clamp(torch.stack([b.max() for b in bands]).max(),
                           min=1e-30)
        frames = torch.stack([
            _tone_map(b, riaf.tone_map, peak=peak).reshape(resolution)
            for b in bands]).to(torch.float32)

    em = np.stack([_host(b, resolution) for b in bands])
    status = _host(res.status)
    stats = dict(
        times=np.asarray(times),
        light_curve=em.sum(axis=(1, 2)),
        emission=em,
        optical_depth=tau,
        t_max=float(_host(res.tau_hat).max()),
        spot_period=2.0 * np.pi / abs(keplerian_omega(
            float(metric.M), float(metric.a), riaf.spot_r, riaf.prograde,
            Q=_charge(metric))),
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return frames, stats


def render_volumetric_decomposed(scene: SceneConfig, resolution,
                                 cfg: RenderConfig = RenderConfig(),
                                 riaf: RIAFConfig = RIAFConfig(),
                                 n_orders: int = 3, mesh=None,
                                 device="cuda"):
    """Photon-ring decomposition of a volumetric image from one trace;
    returns (layers, stats).

    Layer n collects the path emission picked up after n equatorial
    crossings (make_order_transfer's winding coordinate): n = 0 the
    direct image of the flow, n = 1 the first lensed image, n >= 2 the
    demagnified photon subrings on the critical curve. Absorption
    (riaf.alpha0 > 0) screens every order through the shared optical
    depth. layers: (n_orders, H, W) raw linear intensity, float32 on
    `device` (disk.decomposed_display tone-maps them on a shared peak).
    stats: alpha_crit, flux_per_order, flux_ratios, gamma_estimates
    (-ln ratio, the measured demagnification exponent), mean_radius_rad
    per order, winding (the final m map), optical_depth, captured,
    invalid, integrator_steps, total_rays, traced_rays, timings.
    """
    if mesh is not None:
        raise _not_ported("the multi-device order decomposition (mesh)")
    metric = _scene_metric(scene)
    transfer_fn = make_order_transfer(metric, riaf, n_orders)
    timer = StageTimer(device)
    height, width = resolution
    fov, res, orders, tau = _extras_trace(
        metric, scene, resolution, cfg, device, timer, transfer_fn,
        n_orders, riaf.alpha0 > 0.0)

    with timer.stage("render"):
        # The bucket windows make the integrand discontinuous in lambda,
        # so a nearly empty order can collect tiny negative increments
        # from the overshoot of rejected probes; intensities are
        # nonnegative and the noise is far below the partition tolerance.
        layers = torch.stack([
            torch.clamp(o.reshape(resolution), min=0.0)
            for o in orders]).to(torch.float32)

    em = _host(layers).astype(np.float64)
    flux = em.sum(axis=(1, 2))
    yy = (np.arange(height) - height / 2.0) * (fov[0] / height)
    xx = (np.arange(width) - width / 2.0) * (fov[1] / width)
    rad = np.hypot(yy[:, None], xx[None, :])
    mean_r = (em * rad).sum(axis=(1, 2)) / np.maximum(flux, 1e-30)
    ratios = flux[1:] / np.maximum(flux[:-1], 1e-300)
    status = _host(res.status)
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device),
        flux_per_order=flux.tolist(),
        flux_ratios=ratios.tolist(),
        gamma_estimates=(-np.log(np.maximum(ratios, 1e-300))).tolist(),
        mean_radius_rad=mean_r.tolist(),
        winding=_host(res.tau_hat, resolution),
        optical_depth=tau,
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return layers, stats
