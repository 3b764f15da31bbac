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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.ops.batch import trace_batch
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
