"""End-to-end pipeline: camera grids -> ray tracing -> shadow image or
lensed render.

The shadow and lensed-render paths of `light_path_tracer_tpu.pipeline`:
per-pixel (alpha, theta) grids, one trace (whole-grid, or chunked by
`RenderConfig.chunk_size`), the uint16 winding clip, and for Kerr the
axis-refine column band and the top/bottom mirror fold (spherically
symmetric metrics trace every pixel from alpha alone); then the shadow
image, or the renderer's texture gather. This package is
eager, so `render_scene` runs its stages one after another with true
per-stage times. The device is explicit and defaults to CUDA; nothing
moves to another device by itself.

The lens-map products: the photon-ring layers (`render_rings`,
`lensed_ring_layers`, `render_scene_rings`) and the magnification map
(`render_magnification`) read the frame's precompute; the source-plane
modes (`render_caustics`, `render_microlens_curve`, `render_time_delay`,
`render_shear`, and images.find_point_images) trace the whole grid onto
the capture surface through the surface kernel
(ops/cuda/surface_kernel.py) and read the side-exact source chart of the
raw escape state (`_trace_escape_beta`). The JAX package's one-program
wrappers of each mode are one eager body here; `mesh=` raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch import render as _render
from light_path_tracer_tpu_torch.render import _render_core
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer


@dataclasses.dataclass
class PrecomputeResult:
    final_alpha: torch.Tensor     # (H, W) float32, NaN = shadow
    winding: torch.Tensor         # (H, W) uint16
    total_rays: int
    traced_rays: int
    integrator_steps: torch.Tensor  # () int64, on the trace's device

    @property
    def steps(self) -> int:
        return int(self.integrator_steps)


@dataclasses.dataclass
class RenderOutput:
    image: Any                    # (H, W[, C]) in the source's dtype
    alpha_lookup: torch.Tensor
    precompute: PrecomputeResult
    alpha_crit: float
    timings: dict
    scene: SceneConfig
    render_cfg: RenderConfig


def _dtype_of(cfg: RenderConfig):
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def _use_tb(scene: SceneConfig, cfg: RenderConfig) -> bool:
    # A vertical boost component breaks the up/down mirror symmetry.
    return (cfg.use_tb_symmetry
            and bool(np.isclose(scene.theta_obs, np.pi / 2))
            and bool(np.isclose(scene.psi[0], 0.0))
            and float(scene.boost[1]) == 0.0)


def precompute_final_alpha(scene: SceneConfig, cfg: RenderConfig,
                           image_dimension, fov, alpha_lookup=None,
                           device="cuda") -> PrecomputeResult:
    """Trace one ray per pixel; returns per-pixel (final_alpha, winding).

    Spherically symmetric metrics trace every pixel. Kerr applies the
    axis-refine band and, when the scene allows it, the top/bottom mirror
    symmetry, so only (H + 1) // 2 rows are traced. alpha_lookup: the
    (H, W) alpha grid when the caller has built it already.
    """
    fov = (float(fov[0]), float(fov[1]))
    image_dimension = (int(image_dimension[0]), int(image_dimension[1]))
    return _precompute_eager(scene, cfg, image_dimension, fov, device,
                             alpha_lookup)


def _alpha_grid(scene: SceneConfig, cfg: RenderConfig, image_dimension,
                fov, device, alpha_lookup=None):
    """The (H, W) alpha grid in the compute dtype (`alpha_lookup` when the
    caller has built it already)."""
    if alpha_lookup is not None:
        return alpha_lookup.to(_dtype_of(cfg))
    return camera.build_alpha_lookup(image_dimension, fov, psi=scene.psi,
                                     dtype=_dtype_of(cfg), boost=scene.boost,
                                     device=device)


def trace_inputs(scene: SceneConfig, cfg: RenderConfig, image_dimension,
                 fov, device="cuda", alpha_lookup=None):
    """The Kerr rays one frame traces: (alpha, theta, axis_refine)
    flattened in raster order over the traced rows, and the number of
    traced rows (the top (H + 1) // 2 under the mirror symmetry)."""
    dtype = _dtype_of(cfg)
    height, width = image_dimension
    grid = dict(psi=scene.psi, boost=scene.boost, device=device)
    alpha = _alpha_grid(scene, cfg, image_dimension, fov, device,
                        alpha_lookup)
    theta_lookup = camera.build_theta_lookup(image_dimension, fov,
                                             dtype=dtype, **grid)
    refine_cols = camera.axis_refine_columns(
        image_dimension, fov, refine_frac=cfg.axis_refine_frac, **grid)

    trace_rows = (height + 1) // 2 if _use_tb(scene, cfg) else height
    alpha_t = alpha[:trace_rows].reshape(-1)
    theta_t = theta_lookup[:trace_rows].reshape(-1)
    refine_t = refine_cols[None, :].expand(trace_rows, width).reshape(-1)
    return alpha_t, theta_t, refine_t, trace_rows


def _winding_clip(n_half, cfg: RenderConfig):
    """The uint16 winding clip, in int32: torch.uint16 supports few
    operations, so callers cast to uint16 last."""
    return torch.clamp(n_half, 0, cfg.winding_max).to(torch.int32)


def _precompute_eager(scene: SceneConfig, cfg: RenderConfig,
                      image_dimension, fov, device,
                      alpha_lookup=None) -> PrecomputeResult:
    metric = scene.metric()
    height, width = image_dimension
    if metric.is_spherically_symmetric:
        alpha = _alpha_grid(scene, cfg, image_dimension, fov, device,
                            alpha_lookup)
        res = trace_batch(metric, scene.r_obs, alpha.reshape(-1),
                          chunk_size=None, phi_max=cfg.phi_max,
                          h_max=cfg.h_max, backend=cfg.backend)
        fa = res.final_alpha.reshape(image_dimension).to(torch.float32)
        wind = _winding_clip(res.n_half_orbits, cfg).reshape(image_dimension)
        return PrecomputeResult(fa, wind.to(torch.uint16), height * width,
                                height * width, res.n_steps)

    alpha_t, theta_t, refine_t, trace_rows = trace_inputs(
        scene, cfg, image_dimension, fov, device, alpha_lookup)
    use_tb = _use_tb(scene, cfg)

    res = trace_batch(
        metric, scene.r_obs, alpha_t, theta_t, scene.theta_obs, refine_t,
        chunk_size=cfg.chunk_size,
        sort_by_difficulty=cfg.sort_by_difficulty,
        max_steps=cfg.max_steps, backend=cfg.backend,
        integrator=cfg.integrator, event_interp=cfg.event_interp,
        two_pass=cfg.two_pass, pass1_steps=cfg.pass1_steps,
        formulation=cfg.formulation, precision=cfg.precision,
        progress=cfg.progress)

    fa_rows = res.final_alpha.reshape(trace_rows, width).to(torch.float32)
    w_rows = _winding_clip(res.n_half_orbits, cfg).reshape(trace_rows, width)

    if use_tb:
        top_half = height // 2
        fa = torch.full((height, width), float("nan"), dtype=torch.float32,
                        device=fa_rows.device)
        wind = torch.zeros((height, width), dtype=torch.int32,
                           device=w_rows.device)
        fa[:trace_rows] = fa_rows
        wind[:trace_rows] = w_rows
        if top_half > 0:
            fa[height - top_half:] = fa[:top_half].flip(0)
            wind[height - top_half:] = wind[:top_half].flip(0)
    else:
        fa, wind = fa_rows, w_rows

    return PrecomputeResult(fa, wind.to(torch.uint16), height * width,
                            trace_rows * width, res.n_steps)


def render_shadow(scene: SceneConfig, resolution,
                  cfg: RenderConfig = RenderConfig(),
                  analytic: bool = False, device="cuda"):
    """Black-hole shadow image: white background, black where captured.

    analytic=True is the zero-integration threshold test against
    alpha_crit; analytic=False integrates every pixel ray. Returns
    (image (H, W) float32 in {0, 1} on `device`, stats dict).
    """
    metric = scene.metric()
    timer = StageTimer(device)
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device)

    if analytic:
        with timer.stage("render"):
            alpha = _alpha_grid(scene, cfg, resolution, fov, device)
            image = torch.where(alpha < alpha_crit, 0.0, 1.0).to(
                torch.float32)
        stats = dict(total_rays=height * width, traced_rays=0,
                     integrator_steps=0)
    else:
        with timer.stage("precompute"):
            pre = precompute_final_alpha(scene, cfg, resolution, fov,
                                         device=device)
        with timer.stage("render"):
            image = torch.where(torch.isnan(pre.final_alpha), 0.0, 1.0).to(
                torch.float32)
        stats = dict(total_rays=pre.total_rays,
                     traced_rays=pre.traced_rays,
                     integrator_steps=pre.steps)

    stats["alpha_crit"] = alpha_crit
    stats["timings"] = timer.finish()
    return image, stats


def _source_tensor(source_image, device):
    """Source image -> tensor on `device`; uint8 becomes float32 / 255."""
    img = torch.as_tensor(source_image, device=device)
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) / 255.0
    return img


def render_scene(scene: SceneConfig, source_image,
                 cfg: RenderConfig = RenderConfig(),
                 device="cuda") -> RenderOutput:
    """Full lensed render of `source_image` (the image_lens.main pipeline).

    source_image: (H, W[, C]) array or tensor, C in 1..4, float or uint8.
    Stages, each timed on its own (a CUDA device is synchronised at each
    stage's end): load_image, build_lookup (the alpha grid), precompute
    (the trace), render (the theta grid and the texture gather), then
    total. The image has the source's shape and (float) dtype.
    """
    metric = scene.metric()
    timer = StageTimer(device)

    height, width = tuple(source_image.shape[:2])
    fov = camera.fov_from_vertical(scene.vertical_fov, (height, width))
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device)

    with timer.stage("load_image"):
        img = _source_tensor(source_image, device)

    with timer.stage("build_lookup"):
        alpha_lookup = _alpha_grid(scene, cfg, (height, width), fov, device)

    with timer.stage("precompute"):
        pre = precompute_final_alpha(scene, cfg, (height, width), fov,
                                     alpha_lookup=alpha_lookup,
                                     device=device)

    with timer.stage("render"):
        theta_lookup = camera.build_theta_lookup(
            (height, width), fov, psi=scene.psi,
            dtype=pre.final_alpha.dtype, boost=scene.boost, device=device)
        frame = camera.psi_frame(scene.psi)
        lensed = _render_core(img, theta_lookup, pre.final_alpha,
                              pre.winding, frame.d, frame.e_x, frame.e_y,
                              (height, width), fov, cfg.render_loop_around,
                              cfg.sampling)

    timings = timer.finish()
    return RenderOutput(lensed, alpha_lookup, pre, alpha_crit, timings,
                        scene, cfg)


def print_benchmark_summary(image_dimension, alpha_crit, total_rays,
                            traced_rays, timings):
    """The reference's benchmark summary, plus rays/s."""
    height, width = image_dimension
    pixel_count = width * height
    render_time = max(timings.get("render", 0.0), 1e-12)
    total_time = max(timings.get("total", 0.0), 1e-12)
    # The AA renders time their trace and render as one stage.
    precompute_time = max(timings.get(
        "precompute", timings.get("precompute+render", 0.0)), 1e-12)

    print("\nBenchmark summary")
    print(f"  resolution: {width}x{height} ({pixel_count:,} pixels)")
    print(f"  alpha_crit: {alpha_crit:.6f} rad")
    print(f"  total rays: {total_rays:,}")
    print(f"  traced rays: {traced_rays:,}")
    for key in ("load_image", "build_lookup", "precompute", "render",
                "save_image", "total"):
        print(f"  {key:<26}{timings.get(key, 0.0):>10.3f} s")
    print(f"  {'render_throughput':<26}"
          f"{(pixel_count / render_time) / 1e6:>10.2f} MPix/s")
    print(f"  {'overall_throughput':<26}"
          f"{(pixel_count / total_time) / 1e6:>10.2f} MPix/s")
    print(f"  {'trace_throughput':<26}"
          f"{traced_rays / precompute_time:>10.0f} rays/s")


# ---- photon-ring layers and the lens-map products ----


def _no_mesh(mesh, what):
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...) is not ported to the PyTorch package yet "
            f"(ROADMAP.md, Queue 1)")


def _order_pixels(masks, max_order):
    counts = masks.reshape(masks.shape[0], -1).sum(dim=1).cpu().tolist()
    return {lab: int(c) for lab, c in zip(_render.ring_labels(max_order),
                                          counts)}


def render_rings(scene: SceneConfig, resolution,
                 cfg: RenderConfig = RenderConfig(), max_order: int = 3,
                 device="cuda"):
    """Photon-ring decomposition render (render.ring_decomposition) of
    one precompute. Returns (masks (max_order + 2, H, W) bool, composite
    (H, W, 3) float32, stats with the per-order pixel counts)."""
    timer = StageTimer(device)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    with timer.stage("precompute"):
        pre = precompute_final_alpha(scene, cfg, resolution, fov,
                                     device=device)
    with timer.stage("render"):
        masks, composite = _render.ring_decomposition(
            pre.final_alpha, pre.winding, max_order=max_order)
    metric = scene.metric()
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                     device=device),
        order_pixels=_order_pixels(masks, max_order),
        total_rays=pre.total_rays, traced_rays=pre.traced_rays,
        integrator_steps=pre.steps, timings=timer.finish())
    return masks, composite, stats


def lensed_ring_layers(final_alpha, winding, image, max_order: int = 3):
    """Split a rendered lensed image into photon-ring-order layers from
    the render's own tables (no further trace). Returns (layers
    (max_order + 2, H, W[, C]), order_pixels); the layers are disjoint
    and sum to `image` on the non-shadow pixels."""
    masks, _ = _render.ring_decomposition(final_alpha, winding,
                                          max_order=max_order)
    lensed = torch.as_tensor(image, device=masks.device)
    expand = (lambda m: m) if lensed.dim() == 2 else (lambda m: m[..., None])
    zero = torch.zeros((), dtype=lensed.dtype, device=lensed.device)
    layers = torch.stack([torch.where(expand(m), lensed, zero)
                          for m in masks])
    return layers, _order_pixels(masks, max_order)


def render_scene_rings(scene: SceneConfig, source_image,
                       cfg: RenderConfig = RenderConfig(),
                       max_order: int = 3, device="cuda"):
    """The lensed render of `source_image` split by winding order (one
    trace serves every order). Returns (layers, lensed image, stats)."""
    out = render_scene(scene, source_image, cfg, device=device)
    layers, order_pixels = lensed_ring_layers(
        out.precompute.final_alpha, out.precompute.winding, out.image,
        max_order=max_order)
    stats = dict(order_pixels=order_pixels, alpha_crit=out.alpha_crit,
                 timings=out.timings)
    return layers, out.image, stats


def _finite_max(x, absolute=False):
    v = x[torch.isfinite(x)]
    if absolute:
        v = v.abs()
    return float(v.max()) if v.numel() else float("nan")


def render_magnification(scene: SceneConfig, resolution,
                         cfg: RenderConfig = RenderConfig(), device="cuda"):
    """Signed lensing-magnification map of the scene's celestial lens
    map (render.magnification_map) from one standard precompute. Returns
    (mu (H, W) float32 NaN in the shadow, stats)."""
    timer = StageTimer(device)
    resolution = (int(resolution[0]), int(resolution[1]))
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = _dtype_of(cfg)
    with timer.stage("precompute"):
        pre = precompute_final_alpha(scene, cfg, resolution, fov,
                                     device=device)
    with timer.stage("render"):
        theta_lookup = camera.build_theta_lookup(
            resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
            device=device)
        mu = _render.magnification_map(
            pre.final_alpha.to(dtype), theta_lookup,
            camera.psi_frame(scene.psi), resolution, fov)
    finite = torch.isfinite(mu)
    stats = {
        "timings": timer.finish(),
        "total_rays": resolution[0] * resolution[1],
        "traced_rays": pre.traced_rays,
        "integrator_steps": pre.steps,
        "shadow_pixels": int((~finite).sum()),
        "mu_abs_max": _finite_max(mu, absolute=True),
        "negative_parity_pixels": int((mu[finite] < 0).sum()),
    }
    return mu, stats


def _metric_5d(metric):
    """The 5-D tracer of a metric: a spherically symmetric family traces
    as Kerr (Schwarzschild) or Kerr-Newman (Reissner-Nordstrom) at
    a = 0, which carry the coordinate time and the raw escape state the
    orbit equation drops."""
    if hasattr(metric, "initial_conditions_5d"):
        return metric
    from light_path_tracer_tpu_torch.models import (
        Kerr, KerrNewman, ReissnerNordstrom, Schwarzschild)
    if isinstance(metric, ReissnerNordstrom):
        return KerrNewman(M=metric.M, a=0.0, Q=metric.Q)
    if isinstance(metric, Schwarzschild):
        return Kerr(M=metric.M, a=0.0)
    raise ValueError(
        f"{type(metric).__name__} has no 5-D tracer "
        "(initial_conditions_5d) and no known a = 0 equivalent")


def _lambda_max(r_obs) -> float:
    return max(5000.0, 6.0 * float(r_obs))


def surface_tracer(metric):
    """The surface trace of `metric`: the CUDA surface kernel's wrapper
    (which runs its plain loop on a CPU tensor), or the plain loop on any
    device for a metric with no kernel (a CustomMetric)."""
    if getattr(metric, "supports_kernel", True):
        from light_path_tracer_tpu_torch.ops.cuda.surface_kernel import (
            trace_rays_surface_cuda)
        return trace_rays_surface_cuda
    from light_path_tracer_tpu_torch.ops.kerr_trace import (
        trace_rays_surface)
    return trace_rays_surface


def _trace_escape_beta(scene: SceneConfig, cfg: RenderConfig, resolution,
                       fov, record_time: bool = False, mesh=None,
                       device="cuda"):
    """Trace every pixel onto the capture surface and return the
    side-exact gnomonic source coordinates (bx, by), each (H, W), the
    raw SurfaceResult and the theta grid. The whole grid is traced (the
    side-exact chart needs both halves)."""
    from light_path_tracer_tpu_torch.ops.kerr_trace import ESCAPED
    _no_mesh(mesh, "_trace_escape_beta")
    dtype = _dtype_of(cfg)
    metric = _metric_5d(scene.metric())
    r_obs = scene.r_obs
    grid = dict(psi=scene.psi, dtype=dtype, boost=scene.boost,
                device=device)
    alpha_lookup = camera.build_alpha_lookup(resolution, fov, **grid)
    theta_lookup = camera.build_theta_lookup(resolution, fov, **grid)
    res = surface_tracer(metric)(
        metric, r_obs, alpha_lookup.reshape(-1), theta_lookup.reshape(-1),
        scene.theta_obs, r_surface=float(metric.capture_radius()),
        lambda_max=_lambda_max(r_obs), max_steps=cfg.max_steps,
        precision=cfg.precision, method=cfg.integrator,
        record_time=record_time)
    bx, by = _render.world_escape_beta(
        metric, 2.0 * r_obs, res.theta, res.phi, res.p_r, res.p_theta,
        res.xi, res.status == ESCAPED, scene.theta_obs)
    return (bx.reshape(resolution), by.reshape(resolution), res,
            theta_lookup)


def _surface_stats(timer, resolution, res):
    n_px = resolution[0] * resolution[1]
    return {"timings": timer.finish(), "total_rays": n_px,
            "traced_rays": n_px, "integrator_steps": int(res.n_steps)}


def render_caustics(scene: SceneConfig, resolution,
                    cfg: RenderConfig = RenderConfig(), bins: int = 256,
                    beta_max: float | None = None, mesh=None,
                    device="cuda"):
    """Source-plane magnification (caustic) map by inverse ray shooting
    (render.source_plane_map) on the side-exact escape chart; beta_max
    defaults to 70 % of the FOV half-angle. Returns (A (bins, bins)
    float32, extent, stats)."""
    _no_mesh(mesh, "render_caustics")
    timer = StageTimer(device)
    resolution = (int(resolution[0]), int(resolution[1]))
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    if beta_max is None:
        beta_max = 0.7 * (scene.vertical_fov / 2.0)
    with timer.stage("precompute"):
        bx, by, res, _th = _trace_escape_beta(scene, cfg, resolution, fov,
                                              device=device)
    with timer.stage("render"):
        amap, _extent = _render.source_plane_map(
            bx, by, resolution, fov, float(beta_max), int(bins))
    amap_np = amap.cpu().numpy()
    stats = _surface_stats(timer, resolution, res)
    stats.update(
        beta_max=float(beta_max), A_max=float(amap_np.max()),
        A_far_field=float(np.median(amap_np[amap_np > 0]))
        if (amap_np > 0).any() else float("nan"))
    return amap, (-float(beta_max), float(beta_max)), stats


def render_microlens_curve(scene: SceneConfig, resolution,
                           cfg: RenderConfig = RenderConfig(),
                           impact_u: float = 1.0, span_u: float = 4.0,
                           n_points: int = 81,
                           source_radius_u: float = 0.3, mesh=None,
                           device="cuda"):
    """Microlensing light curve A(t) of a finite circular source on a
    straight source-plane track at impact `impact_u` from -span_u to
    +span_u (units of theta_E = sqrt(4 M / r_obs);
    render.microlens_light_curve). Returns (u_axis, A, stats)."""
    _no_mesh(mesh, "render_microlens_curve")
    timer = StageTimer(device)
    resolution = (int(resolution[0]), int(resolution[1]))
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    theta_e = math.sqrt(4.0 * scene.M / scene.r_obs)
    xs = np.linspace(-span_u, span_u, n_points)
    track = np.stack([xs * theta_e, np.full(n_points, impact_u * theta_e)],
                     axis=-1)
    with timer.stage("precompute"):
        bx, by, res, _th = _trace_escape_beta(scene, cfg, resolution, fov,
                                              device=device)
    with timer.stage("render"):
        curve = _render.microlens_light_curve(
            bx, by, resolution, fov, track,
            float(source_radius_u * theta_e))
    curve_np = curve.cpu().numpy()
    stats = _surface_stats(timer, resolution, res)
    stats.update(theta_E=theta_e, A_peak=float(curve_np.max()),
                 A_baseline=float(curve_np[0]))
    return np.hypot(xs, impact_u), curve, stats


def render_time_delay(scene: SceneConfig, resolution,
                      cfg: RenderConfig = RenderConfig(dtype="float64"),
                      mesh=None, device="cuda"):
    """Per-pixel Fermat arrival-time map: the coordinate time rides the
    surface trace as an error-controlled component, localised on the
    escape sphere r_e = 2 r_obs, and each ray is referenced to the plane
    wave of its own escape direction (render.fermat_tau); float64 by
    default (t grows to ~4 r_obs while image delays are a few M).
    Returns (tau (H, W) relative to its finite minimum, NaN where
    captured or invalid; stats, with the side-exact source coordinates
    "beta_x" / "beta_y" as NumPy arrays)."""
    from light_path_tracer_tpu_torch.ops.kerr_trace import ESCAPED
    _no_mesh(mesh, "render_time_delay")
    timer = StageTimer(device)
    resolution = (int(resolution[0]), int(resolution[1]))
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    metric = _metric_5d(scene.metric())
    r_e = 2.0 * scene.r_obs
    with timer.stage("precompute"):
        bx, by, res, _th = _trace_escape_beta(
            scene, cfg, resolution, fov, record_time=True, device=device)
    with timer.stage("render"):
        tau = _render.fermat_tau(metric, r_e, res.theta, res.phi, res.p_r,
                                 res.p_theta, res.xi, res.t_hit,
                                 res.status == ESCAPED)
        known = ~torch.isnan(tau)
        if bool(known.any()):
            tau = tau - tau[known].min()
        tau = tau.reshape(resolution)
    finite = torch.isfinite(tau)
    stats = _surface_stats(timer, resolution, res)
    stats.update(shadow_pixels=int((~finite).sum()),
                 tau_max=_finite_max(tau), beta_x=bx.cpu().numpy(),
                 beta_y=by.cpu().numpy())
    return tau, stats


def render_shear(scene: SceneConfig, resolution,
                 cfg: RenderConfig = RenderConfig(), mesh=None,
                 device="cuda"):
    """Convergence, shear and rotation maps of the traced lens map
    (render.lens_jacobian_decomposition of the side-exact source chart
    against the image-plane gnomonic grids). Returns (maps, stats): maps
    "kappa", "gamma1", "gamma2", "omega" and "gamma" (= |gamma|), each
    (H, W) float32, NaN within one pixel of the shadow or the chart's
    edge."""
    _no_mesh(mesh, "render_shear")
    timer = StageTimer(device)
    resolution = (int(resolution[0]), int(resolution[1]))
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = _dtype_of(cfg)
    with timer.stage("precompute"):
        bx, by, res, _th = _trace_escape_beta(scene, cfg, resolution, fov,
                                              device=device)
    with timer.stage("render"):
        xb, yb = _render.image_gnomonic_grids(
            resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost,
            device=bx.device)
        kappa, gamma1, gamma2, omega = _render.lens_jacobian_decomposition(
            bx, by, xb, yb)
        gamma = torch.sqrt(gamma1 ** 2 + gamma2 ** 2)
        maps = {k: v.to(torch.float32) for k, v in zip(
            ("kappa", "gamma1", "gamma2", "omega", "gamma"),
            (kappa, gamma1, gamma2, omega, gamma))}
    g, o = maps["gamma"], maps["omega"]
    stats = _surface_stats(timer, resolution, res)
    stats.update(shadow_pixels=int((~torch.isfinite(g)).sum()),
                 gamma_max=_finite_max(g),
                 omega_abs_max=_finite_max(o, absolute=True))
    return maps, stats
