"""Polarized hot-flow images: Stokes (I, Q, U) path integrals through the
Walker-Penrose constant.

The counterpart of the volumetric half of
`light_path_tracer_tpu.polarization` (its docstring derives the
construction). Kerr admits a conserved complex quantity along null
geodesics: for a photon with tangent k and a vector f orthogonal to k and
parallel-transported,

    kappa = (A - iB) (r - i a cos theta),
    A = (k^t f^r - k^r f^t) + a sin^2(theta) (k^r f^phi - k^phi f^r)
    B = sin(theta) [ (r^2 + a^2)(k^phi f^theta - k^theta f^phi)
                     - a (k^t f^theta - k^theta f^t) ]

is constant, which turns polarization transport into algebra at the two
endpoints. Each emission element's polarization vector is the
Levi-Civita contraction f ~ eps(u, k, b) of the flow's 4-velocity, the
photon and the magnetic field direction (vertical, toroidal or radial),
evaluated from the current integrator state; its kappa is inverted at the
camera through the per-ray constants kappa(e1), kappa(e2) of the two
screen-transverse unit vectors, so the element's camera-frame EVPA chi is
available inside the integrand and

    dI = g^p j,  dQ = p0 sin^2(xi) g^p j cos 2chi,
                 dU = p0 sin^2(xi) g^p j sin 2chi

ride the adaptive DP45 loop as three error-controlled extras, with the
four camera constants as per-ray auxiliary inputs. The trace runs on the
tensors' device: the hand-written CUDA kernel
(`ops/cuda/volumetric_kernel.py`, `csrc/kerr_dp45_stokes.cu`) on a CUDA
device, the plain PyTorch loop on the CPU.

The disk half (`render_polarization`, `hotspot_qu_loop`) applies the same
algebra once a ray, at its first disk crossing: the thin disk's Keplerian
emitter (`keplerian_u`) in the field geometry of `field_vector`, the
emitted f and pitch factor (`emission_polarization`) from the crossing
momenta the disk trace records (record_momentum), inverted at the camera
(`observed_polarization`). The disk trace runs through the CUDA kernel's
disk variant on a CUDA device. The JAX module's EVPA tick figure
(`save_polarization_figure`) needs matplotlib and is not ported; the CLI
writes the maps as PNGs and a .npz instead.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.disk import (DiskConfig, HotSpot,
                                              _trace_grid, disk_emission,
                                              hotspot_pattern, keplerian_omega,
                                              r_isco)
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.models.kerr import inverse_metric_terms
from light_path_tracer_tpu_torch.ops.batch import _backend
from light_path_tracer_tpu_torch.operands import kernel_operand
from light_path_tracer_tpu_torch.ops.kerr_trace import CAPTURED, INVALID, _div
from light_path_tracer_tpu_torch.pipeline import _dtype_of
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer

__all__ = ["covariant_metric", "k_contravariant", "walker_penrose",
           "observer_basis", "keplerian_u", "field_vector",
           "emission_polarization", "observed_polarization",
           "render_polarization", "hotspot_qu_loop",
           "make_polarized_volumetric_transfer",
           "render_polarized_volumetric"]

_FIELDS = ("vertical", "toroidal", "radial")


def _signature(p) -> int:
    inversions = sum(p[i] > p[j] for i in range(4) for j in range(i + 1, 4))
    return -1 if inversions % 2 else 1


# The 24 permutations of (0, 1, 2, 3) with their signs, for the
# Levi-Civita contraction.
_PERMS = [(p, _signature(p)) for p in itertools.permutations(range(4))]


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def covariant_metric(M, a, r, th):
    """Covariant Boyer-Lindquist Kerr components (g_tt, g_tphi, g_rr,
    g_thth, g_phiphi), batched over tensors r, th; M and a are Python
    floats or 0-dim tensors."""
    sin2 = torch.sin(th) ** 2
    Sigma = r * r + a * a * torch.cos(th) ** 2
    Delta = r * r - 2.0 * M * r + a * a
    g_tt = -(1.0 - 2.0 * M * r / Sigma)
    g_tphi = -2.0 * M * a * r * sin2 / Sigma
    g_rr = Sigma / Delta
    g_thth = Sigma
    g_phiphi = (r * r + a * a
                + 2.0 * M * a * a * r * sin2 / Sigma) * sin2
    return g_tt, g_tphi, g_rr, g_thth, g_phiphi


def _lower(g, v):
    """Covariant components of contravariant v under the metric g =
    (g_tt, g_tphi, g_rr, g_thth, g_phiphi)."""
    g_tt, g_tphi, g_rr, g_thth, g_phiphi = g
    return (g_tt * v[0] + g_tphi * v[3],
            g_rr * v[1],
            g_thth * v[2],
            g_tphi * v[0] + g_phiphi * v[3])


def _dot(g, u, v):
    ul = _lower(g, u)
    return sum(ul[i] * v[i] for i in range(4))


def k_contravariant(M, a, r, th, p_r, p_th, L, E=1.0):
    """Photon k^mu = (k^t, k^r, k^theta, k^phi) from the canonical
    momentum (p_t = -E, p_r, p_theta, p_phi = L)."""
    gi_tt, gi_tphi, gi_rr, gi_thth, gi_phiphi = inverse_metric_terms(
        M, a, r, th)
    p_t = -E
    return (gi_tt * p_t + gi_tphi * L,
            gi_rr * p_r,
            gi_thth * p_th,
            gi_tphi * p_t + gi_phiphi * L)


def walker_penrose(a, r, th, k, f):
    """(kappa1, kappa2), the real and imaginary parts of the
    Walker-Penrose constant for tangent k and polarization f (both
    contravariant, batched)."""
    sin_th = torch.sin(th)
    A = ((k[0] * f[1] - k[1] * f[0])
         + a * sin_th ** 2 * (k[1] * f[3] - k[3] * f[1]))
    B = sin_th * ((r * r + a * a) * (k[3] * f[2] - k[2] * f[3])
                  - a * (k[0] * f[2] - k[2] * f[0]))
    # (A - iB)(r - i a cos theta)
    ac = a * torch.cos(th)
    kappa1 = A * r - B * ac
    kappa2 = -(B * r + A * ac)
    return kappa1, kappa2


def observer_basis(M, a, r_obs, theta_obs, k_cam):
    """Static-observer screen-transverse unit vectors (e1 ~ theta-hat,
    e2 ~ phi-hat, both orthogonal to u_obs and to k) at the camera.

    Exact at any radius: u_obs is the normalized timelike Killing
    direction, and each basis vector is Gram-Schmidt-projected orthogonal
    to u_obs and to the photon's spatial arrival direction.
    """
    one = torch.ones_like(k_cam[0])
    r = r_obs * one
    th = theta_obs * one
    g = covariant_metric(M, a, r, th)
    zero = torch.zeros_like(r)
    u = (1.0 / torch.sqrt(-g[0]), zero, zero, zero)

    def proj_perp_u(v):
        return tuple(v[i] + _dot(g, v, u) * u[i] for i in range(4))

    def normalize(v):
        n = torch.sqrt(torch.clamp(_dot(g, v, v), min=1e-30))
        return tuple(v[i] / n for i in range(4))

    n_hat = normalize(proj_perp_u(k_cam))    # spatial arrival direction

    def perp(v, *others):
        v = proj_perp_u(v)
        for o in others:
            v = tuple(v[i] - _dot(g, v, o) * o[i] for i in range(4))
        return normalize(v)

    e1 = perp((zero, zero, one, zero), n_hat)
    e2 = perp((zero, zero, zero, one), n_hat, e1)
    return e1, e2


def keplerian_u(M, a, r, prograde=True):
    """Keplerian circular-orbit 4-velocity u^mu at equatorial radius r
    (M and a 0-dim tensors of r's dtype)."""
    sqrtM = _sqrt(M)
    omega = (sqrtM / (r ** 1.5 + a * sqrtM) if prograde
             else -sqrtM / (r ** 1.5 - a * sqrtM))
    th = torch.full_like(r, np.pi / 2)
    g_tt, g_tphi, _g_rr, _g_thth, g_phiphi = covariant_metric(M, a, r, th)
    norm = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi)
    u_t = 1.0 / torch.sqrt(torch.clamp(norm, min=1e-12))
    zero = torch.zeros_like(r)
    return (u_t, zero, zero, u_t * omega)


def field_vector(field, r, prograde=True):
    """Coordinate-frame magnetic-field direction b^mu at the equator:
    vertical = -theta-hat (+z), toroidal = phi-hat, radial = r-hat (only
    the direction matters)."""
    zero = torch.zeros_like(r)
    one = torch.ones_like(r)
    if field == "vertical":
        return (zero, zero, -one, zero)
    if field == "toroidal":
        sign = 1.0 if prograde else -1.0
        return (zero, zero, zero, sign * one)
    if field == "radial":
        return (zero, one, zero, zero)
    raise ValueError(f"b-field must be one of {_FIELDS}, got {field!r}")


def emission_polarization(M, a, r_c, p_r, p_th, L, field="toroidal",
                          prograde=True):
    """Emitted polarization f^mu ~ eps(u, k, b) (unnormalised) and the
    fluid-frame pitch factor sin_xi = |f| / (omega_fluid |b_perp|) in
    [0, 1] at an equatorial crossing (sqrt(-det g) = r^2 there)."""
    th = torch.full_like(r_c, np.pi / 2)
    k = k_contravariant(M, a, r_c, th, p_r, p_th, L)
    u = keplerian_u(M, a, r_c, prograde)
    b = field_vector(field, r_c, prograde)
    g = covariant_metric(M, a, r_c, th)

    u_l, k_l, b_l = _lower(g, u), _lower(g, k), _lower(g, b)
    sqrtg = r_c * r_c
    f = [torch.zeros_like(r_c) for _ in range(4)]
    for (mu, nu, rho, sig), sgn in _PERMS:
        f[mu] = f[mu] + sgn * u_l[nu] * k_l[rho] * b_l[sig] / sqrtg
    f = tuple(f)

    omega_fluid = -_dot(g, k, u)
    b_perp = tuple(b[i] + _dot(g, b, u) * u[i] for i in range(4))
    b_norm = torch.sqrt(torch.clamp(_dot(g, b_perp, b_perp), min=1e-30))
    f_norm = torch.sqrt(torch.clamp(_dot(g, f, f), min=0.0))
    sin_xi = torch.clamp(
        f_norm / torch.clamp(omega_fluid * b_norm, min=1e-30), 0.0, 1.0)
    return f, sin_xi


def observed_polarization(metric, r_obs, theta_obs, alphas, thetas,
                          kappa1, kappa2):
    """Invert the Walker-Penrose constant at the camera: (x, y, ok) with
    f_obs = x e1 + y e2 in the screen-transverse basis, ok False where
    the 2x2 solve is degenerate."""
    k11, k21, k12, k22 = camera_constants(metric, r_obs, theta_obs, alphas,
                                          thetas)
    det = k11 * k22 - k12 * k21
    ok = torch.abs(det) > 1e-20
    det_safe = torch.where(ok, det, torch.ones_like(det))
    x = (kappa1 * k22 - kappa2 * k12) / det_safe
    y = (kappa2 * k11 - kappa1 * k21) / det_safe
    return x, y, ok


def _trace_disk_momentum(metric, scene, cfg, disk, alpha, theta,
                         mesh=None):
    """The polarized disk paths' trace, crossing momenta recorded; flat
    ray arrays."""
    if mesh is not None:
        raise NotImplementedError(
            "the multi-device polarized disk trace (mesh) is not ported "
            "to the PyTorch package yet (ROADMAP.md, Queue 1)")
    return _trace_grid(metric, scene, cfg, disk, alpha, theta,
                       record_momentum=True)


def _disk_polarization(scene, cfg, disk, field, resolution, mesh, device,
                       timer, what):
    """The per-pixel algebra shared by the disk paths: (res, alpha,
    r_in, hit, sin_xi, x, y, ok) of the first crossing."""
    if any(abs(p) > 1e-12 for p in scene.psi):
        raise ValueError(f"{what} requires psi = (0, 0) (BH-centered "
                         f"camera)")
    if getattr(scene, "Q", 0.0):
        raise ValueError("polarized rendering supports uncharged (Kerr)"
                         " scenes only; got Q != 0")
    metric = Kerr(M=scene.M, a=scene.a)
    dtype = _dtype_of(cfg)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)

    with timer.stage("build_lookup"):
        grid = dict(dtype=dtype, boost=scene.boost, device=device)
        alpha = camera.build_alpha_lookup(resolution, fov, **grid)
        theta = camera.build_theta_lookup(resolution, fov, **grid)

    with timer.stage("precompute"):
        res = _trace_disk_momentum(metric, scene, cfg, disk, alpha, theta,
                                   mesh=mesh)

    with timer.stage("render"):
        t = dict(dtype=dtype, device=device)
        M = torch.tensor(float(scene.M), **t)
        a = torch.tensor(float(scene.a), **t)
        hit = res.n_hits > 0
        r_in = float(disk.r_in if disk.r_in is not None
                     else r_isco(scene.M, scene.a, disk.prograde))
        r_c = torch.clamp(res.r_hits[0], min=r_in)
        f_em, sin_xi = emission_polarization(
            M, a, r_c, res.pr_hits[0], res.pth_hits[0], res.xi,
            field=field, prograde=disk.prograde)
        th_eq = torch.full_like(r_c, np.pi / 2)
        k_em = k_contravariant(M, a, r_c, th_eq, res.pr_hits[0],
                               res.pth_hits[0], res.xi)
        kappa1, kappa2 = walker_penrose(a, r_c, th_eq, k_em, f_em)
        x, y, ok = observed_polarization(
            metric, scene.r_obs, scene.theta_obs, alpha.reshape(-1),
            theta.reshape(-1), kappa1, kappa2)
    return res, r_in, hit, sin_xi, x, y, ok


def render_polarization(scene: SceneConfig, resolution,
                        cfg: RenderConfig = RenderConfig(),
                        disk: DiskConfig = DiskConfig(),
                        field: str = "toroidal", mesh=None, device="cuda"):
    """Polarized accretion-disk image; returns (evpa, pol_frac, intensity,
    stats), (H, W) float32 NumPy arrays.

    evpa: the electric-vector position angle in radians from the image +x
    axis, in (-pi/2, pi/2], NaN where there is no disk emission;
    pol_frac: the synchrotron pitch weight sin^2(xi) in [0, 1];
    intensity: the imaging path's emission of the same trace. First
    (opaque) crossing only; the camera must be centred on the hole (psi
    = 0) and the scene uncharged.
    """
    timer = StageTimer(device)
    res, r_in, hit, sin_xi, x, y, ok = _disk_polarization(
        scene, cfg, disk, field, resolution, mesh, device, timer,
        "render_polarization")
    with timer.stage("render"):
        # Screen mapping: e2 (phi-hat) -> image -x, e1 (theta-hat) ->
        # image +y (down); the EVPA from the image +x axis, mod pi.
        evpa = torch.atan2(x, -y)
        evpa = torch.remainder(evpa + np.pi / 2, np.pi) - np.pi / 2
        good = hit & ok & (sin_xi > 0.0)
        evpa = torch.where(good, evpa, torch.nan)
        pol = torch.where(good, sin_xi ** 2, 0.0)
        intensity, _rgb = disk_emission(scene, disk, r_in, res.n_hits,
                                        res.r_hits, res.xi,
                                        xi_hits=res.xi_hits)

    def host(v):
        return v.detach().cpu().numpy().astype(np.float32).reshape(
            resolution)

    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde),
        field=field,
        disk_pixels=int(hit.sum()),
        polarized_pixels=int(good.sum()),
        integrator_steps=int(res.n_steps),
        total_rays=resolution[0] * resolution[1],
        traced_rays=resolution[0] * resolution[1],
        timings=timer.finish())
    return host(evpa), host(pol), host(intensity), stats


def hotspot_qu_loop(scene: SceneConfig, resolution, times,
                    cfg: RenderConfig = RenderConfig(),
                    disk: DiskConfig = DiskConfig(), spot=None,
                    field: str = "toroidal", mesh=None, device="cuda"):
    """Integrated Stokes (Q, U) against time for an orbiting hot spot,
    from one trace: the per-pixel EVPA and pitch weight do not change
    with time, only the spot's pattern advects. Returns (times, I, Q, U,
    stats) as float64 NumPy arrays (Q + iU = sum_px I p exp(2 i chi))."""
    spot = spot if spot is not None else HotSpot()
    timer = StageTimer(device)
    times = list(times)
    res, r_in, hit, sin_xi, x, y, ok = _disk_polarization(
        scene, cfg, disk, field, resolution, mesh, device, timer,
        "hotspot_qu_loop")
    with timer.stage("render"):
        evpa = torch.atan2(x, -y)
        good = hit & ok
        p_cos = torch.where(good, sin_xi ** 2 * torch.cos(2.0 * evpa), 0.0)
        p_sin = torch.where(good, sin_xi ** 2 * torch.sin(2.0 * evpa), 0.0)
        pattern = hotspot_pattern(spot, scene.M, scene.a, disk.prograde)
        ts = torch.tensor(times, dtype=_dtype_of(cfg), device=device)
        curves = []
        for t in ts:
            intensity, _rgb = disk_emission(
                scene, disk, r_in, res.n_hits, res.r_hits, res.xi,
                pattern=pattern, phi_hits=res.phi_hits, t=t,
                xi_hits=res.xi_hits)
            curves.append(torch.stack([intensity.sum(),
                                       (intensity * p_cos).sum(),
                                       (intensity * p_sin).sum()]))
        iqu = (torch.stack(curves).cpu().numpy().astype(np.float64)
               if curves else np.zeros((0, 3)))

    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde),
        field=field,
        orbit_period=abs(2.0 * np.pi / keplerian_omega(
            scene.M, scene.a, spot.r0, disk.prograde)),
        disk_pixels=int(hit.sum()),
        n_samples=len(times),
        total_rays=resolution[0] * resolution[1],
        traced_rays=resolution[0] * resolution[1],
        timings=timer.finish())
    return (np.asarray(times, np.float64), iqu[:, 0], iqu[:, 1],
            iqu[:, 2], stats)


def _field_vector_offplane(field, r, th, prograde=True):
    """Coordinate-frame field direction at (r, theta): vertical = +z =
    cos(theta) d_r - sin(theta)/r d_theta, toroidal = phi-hat, radial =
    r-hat. Only the direction matters (the contraction normalizes
    through sin_xi)."""
    zero = torch.zeros_like(r)
    one = torch.ones_like(r)
    if field == "vertical":
        return (zero, torch.cos(th),
                -torch.sin(th) / torch.clamp(r, min=1e-6), zero)
    if field == "toroidal":
        sign = 1.0 if prograde else -1.0
        return (zero, zero, zero, sign * one)
    if field == "radial":
        return (zero, one, zero, zero)
    raise ValueError(f"b-field must be one of {_FIELDS}, got {field!r}")


def _flow_u_offplane(M, a, r, th, prograde=True):
    """Circular 4-velocity at (r, theta), Keplerian where that orbit is
    timelike and ZAMO inside: the flow field of volumetric._profile_fns
    in 4-vector form."""
    g_tt, g_tphi, _g_rr, _g_thth, g_phiphi = covariant_metric(M, a, r, th)
    sqrtM = _sqrt(M)
    # the kernel divides the Python-float numerator by the tensor (PyTorch
    # would multiply its reciprocal)
    om_k = (_div(sqrtM, r ** 1.5 + a * sqrtM) if prograde
            else _div(-sqrtM, r ** 1.5 - a * sqrtM))
    om_z = -g_tphi / torch.clamp(g_phiphi, min=1e-30)

    def timelike(om):
        return -(g_tt + 2.0 * om * g_tphi + om * om * g_phiphi)

    om = torch.where(timelike(om_k) > 1e-3, om_k, om_z)
    u_t = 1.0 / torch.sqrt(torch.clamp(timelike(om), min=1e-12))
    zero = torch.zeros_like(r)
    return (u_t, zero, zero, u_t * om)


def _local_polarization(M, a, r, th, p_r, p_th, L, field, prograde):
    """(kappa1, kappa2, sin_xi) of the synchrotron emission element at
    (r, theta): f ~ eps(u, k, b) with sqrt(-det g) = Sigma |sin theta|
    (an overall sign of f flips kappa, which the quadratic Stokes
    construction cannot see), and the fluid-frame pitch factor sin_xi =
    |f| / (omega_fluid |b_perp|) in [0, 1]."""
    k = k_contravariant(M, a, r, th, p_r, p_th, L)
    u = _flow_u_offplane(M, a, r, th, prograde)
    b = _field_vector_offplane(field, r, th, prograde)
    g = covariant_metric(M, a, r, th)

    u_l, k_l, b_l = _lower(g, u), _lower(g, k), _lower(g, b)
    Sigma = r * r + a * a * torch.cos(th) ** 2
    sqrtg = torch.clamp(Sigma * torch.abs(torch.sin(th)), min=1e-12)
    f = [torch.zeros_like(r) for _ in range(4)]
    for (mu, nu, rho, sig), sgn in _PERMS:
        f[mu] = f[mu] + sgn * u_l[nu] * k_l[rho] * b_l[sig] / sqrtg
    f = tuple(f)

    omega_fluid = -_dot(g, k, u)
    b_perp = tuple(b[i] + _dot(g, b, u) * u[i] for i in range(4))
    b_norm = torch.sqrt(torch.clamp(_dot(g, b_perp, b_perp), min=1e-30))
    f_norm = torch.sqrt(torch.clamp(_dot(g, f, f), min=0.0))
    sin_xi = torch.clamp(
        f_norm / torch.clamp(omega_fluid * b_norm, min=1e-30), 0.0, 1.0)
    kappa1, kappa2 = walker_penrose(a, r, th, k, f)
    return kappa1, kappa2, sin_xi


@functools.lru_cache(maxsize=32)
def make_polarized_volumetric_transfer(metric, riaf, field: str, p0: float):
    """transfer_fn(y, p_t, p_phi, aux) -> (dI, dQ, dU) for
    trace_rays_aux, with aux = (k11, k21, k12, k22) the camera-side
    Walker-Penrose constants kappa(e1), kappa(e2) of each ray.

    Depolarization along the line of sight (crossed EVPAs cancelling in
    Q and U) comes out of the integral itself. Kerr only (the constant
    is the Kerr form) and optically thin (absorption would need the
    transport of the attenuated Stokes vector).
    """
    from light_path_tracer_tpu_torch.volumetric import (KernelTransfer,
                                                        _profile_fns,
                                                        make_transfer_fns)
    if getattr(metric, "Q", 0.0) or getattr(metric, "eps3", 0.0):
        raise ValueError("polarized volumetric rendering supports "
                         "uncharged Kerr scenes only")
    if field not in _FIELDS:
        raise ValueError(f"b-field must be one of {_FIELDS}, "
                         f"got {field!r}")
    if riaf.alpha0:
        raise ValueError("polarized volumetric mode is optically thin "
                         "(alpha0 must be 0): absorption would need "
                         "the full polarized transfer equation")
    make_transfer_fns(metric, riaf)               # validates the config
    _j_rest, _g_clipped = _profile_fns(metric, riaf)
    M = float(metric.M)
    a = float(metric.a)

    def transfer_fn(y, p_t, p_phi, aux):
        k11, k21, k12, k22 = aux
        r, th = y[0], y[1]
        j = _j_rest(r, torch.cos(th))
        # the kernel calls pow (operands.py)
        w = (1.0 if riaf.g_power == 0.0
             else _g_clipped(y[:5], p_t, p_phi) ** kernel_operand(
                 riaf.g_power, y))
        # E = 1 (p_t = -1), so L = p_phi.
        kappa1, kappa2, sin_xi = _local_polarization(
            M, a, r, th, y[3], y[4], p_phi, field, riaf.prograde)
        det = k11 * k22 - k12 * k21
        ok = torch.abs(det) > 1e-20
        det_s = torch.where(ok, det, torch.ones_like(det))
        x = (kappa1 * k22 - kappa2 * k12) / det_s
        yv = (kappa2 * k11 - kappa1 * k21) / det_s
        n2 = x * x + yv * yv
        good = ok & (n2 > 1e-24)
        n2_s = torch.where(good, n2, torch.ones_like(n2))
        # chi = atan2(-x, yv); Stokes needs only (cos 2chi, sin 2chi).
        cos2 = (yv * yv - x * x) / n2_s
        sin2 = -2.0 * x * yv / n2_s
        A = torch.where(good, p0 * sin_xi ** 2 * w * j,
                        torch.zeros_like(j))
        return (w * j, A * cos2, A * sin2)

    transfer_fn.kernel = KernelTransfer("stokes", metric, riaf, field=field,
                                        p0=float(p0))
    return transfer_fn


def camera_constants(metric, r_obs, theta_obs, alpha, theta):
    """The per-ray camera-side Walker-Penrose constants (k11, k21, k12,
    k22) = (kappa(e1), kappa(e2)) of rays (alpha, theta), in their dtype
    on their device."""
    y0, _p_t, p_phi, _inv = metric.initial_conditions_5d(
        r_obs, alpha, theta, theta_obs)
    M = torch.full((), float(metric.M), dtype=alpha.dtype,
                   device=alpha.device)
    a = torch.full((), float(metric.a), dtype=alpha.dtype,
                   device=alpha.device)
    k_cam = k_contravariant(M, a, y0[0], y0[1], y0[3], y0[4], p_phi)
    e1, e2 = observer_basis(M, a, r_obs, theta_obs, k_cam)
    k11, k21 = walker_penrose(a, y0[0], y0[1], k_cam, e1)
    k12, k22 = walker_penrose(a, y0[0], y0[1], k_cam, e2)
    return tuple(k.contiguous() for k in (k11, k21, k12, k22))


def render_polarized_volumetric(scene: SceneConfig, resolution,
                                cfg: RenderConfig = RenderConfig(),
                                riaf=None, field: str = "toroidal",
                                p0: float = 0.7, mesh=None, device="cuda"):
    """Polarized hot-flow image: Stokes (I, Q, U) integrated along every
    geodesic in one trace; returns (evpa, pol_frac, intensity, stats),
    NumPy arrays as the JAX package returns them.

    evpa: radians from the image +x axis, NaN where unpolarized or dark;
    pol_frac = sqrt(Q^2 + U^2) / I in [0, p0] (beam depolarization shows
    as pol_frac < p0 although every element emits at p0); stats carries
    the raw Stokes maps (stats["I"], ["Q"], ["U"]), captured, invalid,
    integrator_steps, total_rays, timings. The camera must be centered
    on the hole and static (psi = 0, boost = 0): the screen-basis
    mapping assumes it.
    """
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_rays_aux_two_pass)
    from light_path_tracer_tpu_torch.ops.cuda.volumetric_kernel import (
        trace_rays_aux_cuda)
    from light_path_tracer_tpu_torch.volumetric import (RIAFConfig,
                                                        _lambda_max,
                                                        _lookups,
                                                        _two_pass_on)
    riaf = riaf if riaf is not None else RIAFConfig()
    if any(abs(p) > 1e-12 for p in scene.psi):
        raise ValueError("render_polarized_volumetric requires "
                         "psi = (0, 0) (BH-centered camera)")
    if any(abs(b) > 1e-12 for b in scene.boost):
        raise ValueError("render_polarized_volumetric requires a "
                         "static camera (boost = 0)")
    if getattr(scene, "Q", 0.0) or getattr(scene, "eps3", 0.0):
        raise ValueError("polarized volumetric rendering supports "
                         "uncharged Kerr scenes only")
    if mesh is not None:
        raise NotImplementedError(
            "the multi-device polarized render (mesh) is not ported to "
            "the PyTorch package yet (ROADMAP.md, Queue 1)")
    metric = Kerr(M=scene.M, a=scene.a)
    transfer_fn = make_polarized_volumetric_transfer(metric, riaf, field,
                                                     float(p0))
    timer = StageTimer(device)
    height, width = resolution

    with timer.stage("build_lookup"):
        _fov, alpha, theta = _lookups(scene, resolution, cfg, device)
        aux = camera_constants(metric, scene.r_obs, scene.theta_obs,
                               alpha, theta)

    with timer.stage("precompute"):
        _backend(cfg.backend, alpha)
        aux_fn = (trace_rays_aux_two_pass if _two_pass_on(cfg)
                  else trace_rays_aux_cuda)
        # The saturation exit watches all three Stokes integrals: Q and
        # U change sign along a whirl, but the exit needs every one
        # bitwise frozen, so a lane still depolarizing cannot leave.
        res = aux_fn(metric, scene.r_obs, alpha, theta, scene.theta_obs,
                     transfer_fn, 3, aux, _lambda_max(scene), cfg.max_steps,
                     precision=cfg.precision, method=cfg.integrator,
                     sat_window=cfg.sat_window, sat_monitor=(0, 1, 2))

    I_map, Q_map, U_map = (e.detach().cpu().numpy().reshape(resolution)
                           for e in res.extras)
    pol_int = np.hypot(Q_map, U_map)
    pol_frac = pol_int / np.maximum(I_map, 1e-30)
    evpa = np.where(pol_int > 1e-12 * max(I_map.max(), 1e-30),
                    0.5 * np.arctan2(U_map, Q_map), np.nan)
    status = res.status.detach().cpu().numpy()
    stats = dict(
        I=I_map, Q=Q_map, U=U_map,
        captured=int((status == CAPTURED).sum()),
        invalid=int((status == INVALID).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        timings=timer.finish())
    return (evpa.astype(np.float64), pol_frac.astype(np.float64), I_map,
            stats)
