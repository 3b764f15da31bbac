"""Shadow pipeline: camera grids -> ray tracing -> shadow image.

The shadow main path of `light_path_tracer_tpu.pipeline`: per-pixel
(alpha, theta) grids, the axis-refine column band, one whole-grid trace,
the uint16 winding clip and the top/bottom mirror fold, then the shadow
image. The device is explicit and defaults to CUDA; nothing moves to
another device by itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.ops.batch import trace_batch
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


def _dtype_of(cfg: RenderConfig):
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def _use_tb(scene: SceneConfig, cfg: RenderConfig) -> bool:
    # A vertical boost component breaks the up/down mirror symmetry.
    return (cfg.use_tb_symmetry
            and bool(np.isclose(scene.theta_obs, np.pi / 2))
            and bool(np.isclose(scene.psi[0], 0.0))
            and float(scene.boost[1]) == 0.0)


def precompute_final_alpha(scene: SceneConfig, cfg: RenderConfig,
                           image_dimension, fov,
                           device="cuda") -> PrecomputeResult:
    """Trace one ray per pixel; returns per-pixel (final_alpha, winding).

    Applies the axis-refine band and, when the scene allows it, the
    top/bottom mirror symmetry, so only (H + 1) // 2 rows are traced.
    """
    fov = (float(fov[0]), float(fov[1]))
    image_dimension = (int(image_dimension[0]), int(image_dimension[1]))
    return _precompute_eager(scene, cfg, image_dimension, fov, device)


def trace_inputs(scene: SceneConfig, cfg: RenderConfig, image_dimension,
                 fov, device="cuda"):
    """The rays one frame traces: (alpha, theta, axis_refine) flattened in
    raster order over the traced rows, and the number of traced rows (the
    top (H + 1) // 2 under the mirror symmetry)."""
    dtype = _dtype_of(cfg)
    height, width = image_dimension
    grid = dict(psi=scene.psi, boost=scene.boost, device=device)
    alpha = camera.build_alpha_lookup(image_dimension, fov, dtype=dtype,
                                      **grid)
    theta_lookup = camera.build_theta_lookup(image_dimension, fov,
                                             dtype=dtype, **grid)
    refine_cols = camera.axis_refine_columns(
        image_dimension, fov, refine_frac=cfg.axis_refine_frac, **grid)

    trace_rows = (height + 1) // 2 if _use_tb(scene, cfg) else height
    alpha_t = alpha[:trace_rows].reshape(-1)
    theta_t = theta_lookup[:trace_rows].reshape(-1)
    refine_t = refine_cols[None, :].expand(trace_rows, width).reshape(-1)
    return alpha_t, theta_t, refine_t, trace_rows


def _precompute_eager(scene: SceneConfig, cfg: RenderConfig,
                      image_dimension, fov, device) -> PrecomputeResult:
    metric = scene.metric()
    height, width = image_dimension
    alpha_t, theta_t, refine_t, trace_rows = trace_inputs(
        scene, cfg, image_dimension, fov, device)
    use_tb = _use_tb(scene, cfg)

    res = trace_batch(
        metric, scene.r_obs, alpha_t, theta_t, scene.theta_obs, refine_t,
        chunk_size=cfg.chunk_size, max_steps=cfg.max_steps,
        backend=cfg.backend, integrator=cfg.integrator,
        event_interp=cfg.event_interp, two_pass=cfg.two_pass,
        formulation=cfg.formulation, precision=cfg.precision)

    fa_rows = res.final_alpha.reshape(trace_rows, width).to(torch.float32)
    # torch.uint16 supports few operations: clip and fold in int32.
    w_rows = torch.clamp(res.n_half_orbits, 0, cfg.winding_max).to(
        torch.int32).reshape(trace_rows, width)

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
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs)

    if analytic:
        with timer.stage("render"):
            alpha = camera.build_alpha_lookup(
                resolution, fov, psi=scene.psi, dtype=_dtype_of(cfg),
                boost=scene.boost, device=device)
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
