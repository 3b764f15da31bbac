"""Strong-lensing image-position solver: every image of a point source.

The counterpart of `light_path_tracer_tpu.images`. Given a point source
at gnomonic sky position beta = (beta_x, beta_y) (radians about the BH
direction, render.world_escape_beta's chart), find every image the lens
forms, with its signed magnification, winding order and relative Fermat
delay:

  1. coarse pass: one traced grid (pipeline._trace_escape_beta, the
     surface kernel on a CUDA device) gives the side-exact lens map;
  2. cell detection: the map is linearised on the two triangles of every
     2x2 pixel cell; a triangle whose source-plane image holds beta
     yields a candidate, seeded at its barycentric point;
  3. Newton refinement: a 5-point stencil (the centre and central
     differences in both pixel axes) is retraced per candidate in
     float64 and iterated on F(pixel) = beta(pixel) - beta_target, the
     stencils padded to max_images;
  4. products: at the converged pixel the stencil gives the signed
     magnification (ratio of gnomonic solid-angle elements), the
     winding order and the Fermat time tau = t - X.v (render.fermat_tau,
     the time component riding the trace).

The refinement and the products run in float64 on the caller's device,
where the JAX package takes float64 "when available": this package always
has it. Images closer than about one coarse pixel merge.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer


@dataclass(frozen=True)
class LensedImage:
    """One image of the point source."""

    py: float             # refined pixel row (fractional)
    px: float             # refined pixel column (fractional)
    alpha_rad: float      # angular offset from the BH direction
    screen_theta_rad: float   # screen azimuth about the BH direction
    mu: float             # signed magnification (mu < 0: odd parity)
    winding: int          # n_half_orbits of the image ray
    tau: float            # Fermat arrival time [M], relative
    beta_residual: float  # |beta(pixel) - beta_target| [rad] after Newton
    converged: bool

    @property
    def parity(self) -> int:
        return -1 if self.mu < 0 else 1

    @property
    def delay(self) -> float:
        """tau, already referenced to the earliest image."""
        return self.tau


def _triangle_candidates(bx, by, beta, tol: float = 1e-6):
    """Subpixel seeds (K, 2) = (py, px) from the piecewise-linear lens
    map of the (H, W) NumPy source coordinates bx, by (NaN where
    captured): each 2x2 cell's triangles (00, 01, 10) and (11, 10, 01)
    whose barycentric coordinates of beta all lie in [-tol, 1 + tol]."""
    H, W = bx.shape
    iy, ix = np.mgrid[0:H - 1, 0:W - 1]
    corners = {
        "00": (bx[:-1, :-1], by[:-1, :-1], iy, ix),
        "01": (bx[:-1, 1:], by[:-1, 1:], iy, ix + 1),
        "10": (bx[1:, :-1], by[1:, :-1], iy + 1, ix),
        "11": (bx[1:, 1:], by[1:, 1:], iy + 1, ix + 1),
    }
    seeds = []
    for tri in (("00", "01", "10"), ("11", "10", "01")):
        (ax, ay, apy, apx), (bx_, by_, bpy, bpx), (cx, cy, cpy, cpx) = (
            corners[k] for k in tri)
        finite = (np.isfinite(ax) & np.isfinite(ay) & np.isfinite(bx_)
                  & np.isfinite(by_) & np.isfinite(cx) & np.isfinite(cy))
        e1x, e1y = bx_ - ax, by_ - ay
        e2x, e2y = cx - ax, cy - ay
        det = e1x * e2y - e1y * e2x
        px_, py_ = beta[0] - ax, beta[1] - ay
        safe = np.where(np.abs(det) > 1e-30, det, 1.0)
        w_b = (px_ * e2y - py_ * e2x) / safe
        w_c = (e1x * py_ - e1y * px_) / safe
        w_a = 1.0 - w_b - w_c
        inside = (finite & (np.abs(det) > 1e-30)
                  & (w_a >= -tol) & (w_b >= -tol) & (w_c >= -tol))
        if not inside.any():
            continue
        wa, wb, wc = w_a[inside], w_b[inside], w_c[inside]
        spy = wa * apy[inside] + wb * bpy[inside] + wc * cpy[inside]
        spx = wa * apx[inside] + wb * bpx[inside] + wc * cpx[inside]
        seeds.append(np.stack([spy, spx], axis=-1))
    if not seeds:
        return np.zeros((0, 2))
    return np.concatenate(seeds, axis=0)


def _dedup(points, radius):
    """Greedy distance dedup: keep the first point of every cluster."""
    kept = []
    for p in points:
        if all(np.hypot(p[0] - q[0], p[1] - q[1]) >= radius
               for q in kept):
            kept.append(p)
    return np.asarray(kept) if kept else np.zeros((0, 2))


def _stencil_trace(metric, scene, cfg, resolution, fov, py, px, eps,
                   record_time, device):
    """Trace the 5-point stencil [centre, +px, -px, +py, -py] of K
    candidate pixels in float64 on `device`. Returns (bx, by) as (5, K)
    NumPy arrays (NaN where not escaped) and the raw SurfaceResult
    (flat (5K,))."""
    from light_path_tracer_tpu_torch import render as _render
    from light_path_tracer_tpu_torch.ops.kerr_trace import ESCAPED
    from light_path_tracer_tpu_torch.pipeline import (_lambda_max,
                                                      surface_tracer)

    k = py.shape[0]
    off_y = np.array([0.0, 0.0, 0.0, eps, -eps])
    off_x = np.array([0.0, eps, -eps, 0.0, 0.0])
    sy = (py[None, :] + off_y[:, None]).ravel()
    sx = (px[None, :] + off_x[:, None]).ravel()
    f64 = dict(dtype=torch.float64, device=device)
    al, th = camera.pixel_angles_at(
        torch.tensor(sy, **f64), torch.tensor(sx, **f64), resolution, fov,
        psi=scene.psi, dtype=torch.float64, boost=scene.boost)
    r_obs = scene.r_obs
    res = surface_tracer(metric)(
        metric, r_obs, al, th, scene.theta_obs,
        r_surface=float(metric.capture_radius()),
        lambda_max=_lambda_max(r_obs), max_steps=cfg.max_steps,
        precision=cfg.precision, method=cfg.integrator,
        record_time=record_time)
    bx, by = _render.world_escape_beta(
        metric, 2.0 * r_obs, res.theta, res.phi, res.p_r, res.p_theta,
        res.xi, res.status == ESCAPED, scene.theta_obs)
    return (bx.cpu().numpy().reshape(5, k), by.cpu().numpy().reshape(5, k),
            res)


def _stencil_jacobian(sbx, sby, eps):
    """(j11, j21, j12, j22) = d(bx, by)/d(px), d(bx, by)/d(py)."""
    return ((sbx[1] - sbx[2]) / (2 * eps), (sby[1] - sby[2]) / (2 * eps),
            (sbx[3] - sbx[4]) / (2 * eps), (sby[3] - sby[4]) / (2 * eps))


def find_point_images(scene: SceneConfig, beta, resolution=(512, 512),
                      cfg: RenderConfig = RenderConfig(),
                      max_images: int = 16, refine_iters: int = 8,
                      fd_eps_px: float = 0.05, mesh=None, device="cuda"):
    """Find every image of a point source at `beta` = (beta_x, beta_y)
    [rad, gnomonic about the BH direction].

    The coarse pass runs at `cfg`'s dtype and precision; the Newton
    refinement and every per-image product run in float64. Returns
    (images, stats): LensedImage list sorted by arrival time (tau = 0 at
    the earliest converged image), and the stats dict of the JAX
    package's solver.
    """
    from light_path_tracer_tpu_torch import render as _render
    from light_path_tracer_tpu_torch.ops.kerr_trace import ESCAPED
    from light_path_tracer_tpu_torch.pipeline import (_metric_5d, _no_mesh,
                                                      _trace_escape_beta)
    _no_mesh(mesh, "find_point_images")
    timer = StageTimer(device)
    resolution = (int(resolution[0]), int(resolution[1]))
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    beta = (float(beta[0]), float(beta[1]))
    metric = _metric_5d(scene.metric())

    with timer.stage("precompute"):
        bx, by, res_grid, _th = _trace_escape_beta(scene, cfg, resolution,
                                                   fov, device=device)
    with timer.stage("detect"):
        seeds = _triangle_candidates(bx.cpu().numpy().astype(np.float64),
                                     by.cpu().numpy().astype(np.float64),
                                     beta)
        seeds = _dedup(seeds, radius=0.75)
        n_candidates = len(seeds)
        seeds = seeds[:max_images]
    n_px = resolution[0] * resolution[1]
    if len(seeds) == 0:
        return [], {"timings": timer.finish(), "total_rays": n_px,
                    "traced_rays": n_px,
                    "integrator_steps": int(res_grid.n_steps),
                    "n_candidates": 0, "n_images": 0}

    # Padded to max_images, as the JAX package pads its stencils.
    k = max_images
    pos = np.full((k, 2), resolution[0] / 2.0)
    pos[:len(seeds)] = seeds
    alive = np.zeros(k, dtype=bool)
    alive[:len(seeds)] = True
    h_px = 1.0  # Newton step clamp [pixels]

    with timer.stage("refine"):
        for _ in range(refine_iters):
            sbx, sby, _res = _stencil_trace(
                metric, scene, cfg, resolution, fov, pos[:, 0], pos[:, 1],
                fd_eps_px, False, device)
            fx_ = sbx[0] - beta[0]
            fy_ = sby[0] - beta[1]
            j11, j21, j12, j22 = _stencil_jacobian(sbx, sby, fd_eps_px)
            det = j11 * j22 - j12 * j21
            ok = (np.isfinite(det) & (np.abs(det) > 1e-30)
                  & np.isfinite(fx_) & np.isfinite(fy_))
            alive &= ok
            safe = np.where(ok, det, 1.0)
            dpx = -(j22 * fx_ - j12 * fy_) / safe
            dpy = -(-j21 * fx_ + j11 * fy_) / safe
            step = np.hypot(dpx, dpy)
            scale = np.where(step > h_px, h_px / np.maximum(step, 1e-30),
                             1.0)
            pos[:, 1] += np.where(alive, dpx * scale, 0.0)
            pos[:, 0] += np.where(alive, dpy * scale, 0.0)

    with timer.stage("products"):
        sbx, sby, res = _stencil_trace(
            metric, scene, cfg, resolution, fov, pos[:, 0], pos[:, 1],
            fd_eps_px, True, device)
        fx_ = sbx[0] - beta[0]
        fy_ = sby[0] - beta[1]
        residual = np.hypot(fx_, fy_)
        # Converged within a small fraction of a pixel's angle.
        px_angle = fov[1] / resolution[0]
        converged = alive & (residual < 0.05 * px_angle)
        # Signed magnification: the pinhole chart's solid-angle element
        # (constant Jacobian 1 / (fx fy), measure (1 + x^2 + y^2)^-3/2)
        # over the source chart's (det d(beta)/d(pixel), measure
        # (1 + beta^2)^-3/2).
        j11, j21, j12, j22 = _stencil_jacobian(sbx, sby, fd_eps_px)
        det_src = j11 * j22 - j12 * j21
        fxl, fyl = camera.focal_lengths(resolution, fov)
        x_cam = (pos[:, 1] - resolution[1] / 2) / fxl
        y_cam = (pos[:, 0] - resolution[0] / 2) / fyl
        a_img = (1.0 / (fxl * fyl)
                 / (1.0 + x_cam ** 2 + y_cam ** 2) ** 1.5)
        b2 = sbx[0] ** 2 + sby[0] ** 2
        a_src = det_src / (1.0 + b2) ** 1.5
        safe_src = np.where(np.abs(a_src) > 1e-300, a_src, np.inf)
        mu = a_img / safe_src
        tau_all = _render.fermat_tau(
            metric, 2.0 * scene.r_obs, res.theta, res.phi, res.p_r,
            res.p_theta, res.xi, res.t_hit,
            res.status == ESCAPED).cpu().numpy().reshape(5, k)[0]
        winding = res.n_half_orbits.cpu().numpy().reshape(5, k)[0]

    # Two seeds can converge to one image: dedup the refined positions
    # and reference tau to the earliest converged image.
    order = np.argsort(np.where(np.isfinite(tau_all), tau_all, np.inf))
    images: list[LensedImage] = []
    taken: list[tuple[float, float]] = []
    tau0 = None
    for i in order:
        if not converged[i]:
            continue
        p = (float(pos[i, 0]), float(pos[i, 1]))
        if any(math.hypot(p[0] - q[0], p[1] - q[1]) < 0.5 for q in taken):
            continue
        taken.append(p)
        al, th = camera.pixel_angles_at(
            torch.tensor([p[0]], dtype=torch.float64),
            torch.tensor([p[1]], dtype=torch.float64), resolution, fov,
            psi=scene.psi, dtype=torch.float32, boost=scene.boost)
        tau_i = float(tau_all[i])
        if tau0 is None and np.isfinite(tau_i):
            tau0 = tau_i
        images.append(LensedImage(
            py=p[0], px=p[1], alpha_rad=float(al[0]),
            screen_theta_rad=float(th[0]), mu=float(mu[i]),
            winding=int(winding[i]), tau=tau_i - (tau0 or 0.0),
            beta_residual=float(residual[i]), converged=True))

    stats = {
        "timings": timer.finish(),
        "total_rays": n_px + 5 * k * (refine_iters + 1),
        "traced_rays": n_px,
        "integrator_steps": int(res_grid.n_steps),
        "n_candidates": int(n_candidates),
        "n_images": len(images),
        "total_abs_mu": float(sum(abs(im.mu) for im in images)),
    }
    return images, stats


def format_image_table(images, stats=None) -> str:
    """Human-readable table of a find_point_images result."""
    lines = ["  #  py        px        alpha[deg]  theta[deg]  "
             "mu          parity  wind  delay[M]"]
    for i, im in enumerate(images):
        lines.append(
            f"  {i:<2d} {im.py:<9.2f} {im.px:<9.2f} "
            f"{np.degrees(im.alpha_rad):<11.4f} "
            f"{np.degrees(im.screen_theta_rad):<11.2f} "
            f"{im.mu:<11.4g} {im.parity:+d}      {im.winding:<5d} "
            f"{im.tau:.4f}")
    if stats is not None:
        lines.append(f"  ({stats['n_candidates']} candidates -> "
                     f"{stats['n_images']} images; sum|mu| = "
                     f"{stats.get('total_abs_mu', float('nan')):.4f})")
    return "\n".join(lines)
