"""Supersampled (jittered-AA) rendering.

The counterpart of `light_path_tracer_tpu.aa` (config 5: the 4k Kerr
shadow at 4 samples a pixel). Each AA pass shifts the pinhole grid by a
subpixel offset (a rotated-grid pattern for up to 4 samples, a
golden-ratio sequence beyond). All passes are stacked along the row axis
and traced as one batch; above 8,000,000 rays the batch goes to
`trace_batch` in pass-sized chunks, as in the JAX package. Averaging
happens on the device; only the final image is returned.

Top/bottom mirror symmetry: when the scene is equatorially symmetric
(pipeline._use_tb), only rows 0..H//2 of every pass are traced and the
rest are mirror-filled. The camera maps row r to y = r - H/2, so the
optical axis lies on row H/2 and the mirror pairs rows r <-> H - r (row
0 unpaired). A bottom pixel then carries the sample at the flipped
subpixel offset (-dy, dx): an equally good pattern, whose value is exact
by the scene's symmetry, so the average is a true n-sample render at
about half the traced rays. (The non-AA fold of `pipeline` mirrors about
the grid centre instead, as the reference does.)

The passes trace with cfg.integrator and cfg.event_interp (DOP853 and
linear event location included), as the single-sample render does; the
JAX package's AA trace passes neither and runs DP45 with Hermite events
whatever the config says. Neither package's AA trace passes
cfg.formulation: the passes integrate the theta chart whatever it says.

Single device only: a mesh raises until multi-GPU is ported.
"""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.ops.batch import trace_batch
# One mirror rule for every path: a condition added to one copy but not
# another would mirror-fill rows whose true values differ.
from light_path_tracer_tpu_torch.pipeline import (_dtype_of, _source_tensor,
                                                  _use_tb)
from light_path_tracer_tpu_torch.render import render_lensed_image
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer

# Rotated-grid 4x pattern (pixels); further samples from a golden-ratio
# low-discrepancy sequence.
_RG4 = np.array([(-0.125, -0.375), (0.375, -0.125),
                 (-0.375, 0.125), (0.125, 0.375)])

# Above this many stacked rays the passes are traced one pass-sized chunk
# at a time (the JAX package's rule for its device's large-dispatch
# fault; kept so both packages trace the same batches).
_CHUNK_ABOVE = 8_000_000


def aa_offsets(n_samples: int):
    """(n, 2) array of (dy, dx) subpixel offsets."""
    if n_samples == 1:
        return np.zeros((1, 2))
    if n_samples <= 4:
        return _RG4[:n_samples]
    g = 0.6180339887498949
    extra = np.stack([
        (np.arange(n_samples - 4) * g) % 1.0 - 0.5,
        (np.arange(n_samples - 4) * g * g) % 1.0 - 0.5], axis=1)
    return np.concatenate([_RG4, extra])


def _check_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "AA across a device mesh is not ported to the PyTorch package "
            "yet (ROADMAP.md, Queue 1)")


def _stacked_grids(metric, scene, cfg, resolution, fov, offsets,
                   trace_rows=None, device="cuda"):
    """Per-offset camera grids stacked on the row axis: (S*T, W), built
    pass by pass. trace_rows=T keeps each pass's top T rows (the mirror
    path); None means full passes. theta is None for spherically
    symmetric metrics."""
    grid = dict(psi=scene.psi, dtype=_dtype_of(cfg), boost=scene.boost,
                device=device)
    alphas, thetas = [], []
    for offset in offsets:
        al = camera.build_alpha_lookup(resolution, fov,
                                       pixel_offset=tuple(offset), **grid)
        alphas.append(al[:trace_rows])
        if not metric.is_spherically_symmetric:
            th = camera.build_theta_lookup(resolution, fov,
                                           pixel_offset=tuple(offset), **grid)
            thetas.append(th[:trace_rows])
    theta = torch.cat(thetas) if thetas else None
    return torch.cat(alphas), theta


def _mirror_fill(top, height):
    """(S, R, W) traced rows 0..R-1 -> (S, H, W) via the equatorial mirror.

    R = H//2 + 1. Bottom row r (r >= R) holds the value traced at row
    H - r of the same pass: the sample at subpixel offset (-dy, dx) of
    this pixel, whose traced value equals it by the scene's symmetry.
    """
    n_bottom = height - top.shape[1]
    return torch.cat([top, top[:, 1:n_bottom + 1].flip(1)], dim=1)


def _trace_all_passes(metric, scene, cfg, resolution, fov, offsets,
                      device="cuda"):
    """Trace every AA pass in one batch; returns the per-pass (S, H, W)
    final_alpha / winding / status stacks and the traced ray count.

    Under the mirror symmetry (_use_tb) only rows 0..H//2 of each pass
    are traced and the bottom rows are mirror-filled.
    """
    n_s = len(offsets)
    height, width = resolution
    trace_rows = height // 2 + 1 if _use_tb(scene, cfg) else height
    alpha, theta = _stacked_grids(metric, scene, cfg, resolution, fov,
                                  offsets, trace_rows=trace_rows,
                                  device=device)
    # All passes in one call while the batch is small enough; above that,
    # one pass-sized chunk a call, unsorted (the raster order is already
    # coherent in difficulty).
    chunk = cfg.chunk_size
    if chunk is None and n_s > 1 and alpha.numel() > _CHUNK_ABOVE:
        chunk = trace_rows * width
    res = trace_batch(
        metric, scene.r_obs, alpha.reshape(-1),
        None if theta is None else theta.reshape(-1), scene.theta_obs,
        chunk_size=chunk, sort_by_difficulty=False,
        max_steps=cfg.max_steps, backend=cfg.backend,
        integrator=cfg.integrator, event_interp=cfg.event_interp,
        precision=cfg.precision)

    shape = (n_s, trace_rows, width)
    fa, nh, st = (x.reshape(shape) for x in
                  (res.final_alpha, res.n_half_orbits, res.status))
    if trace_rows < height:
        fa, nh, st = (_mirror_fill(x, height) for x in (fa, nh, st))
    return fa, nh, st, n_s * trace_rows * width


def _pass_thetas(metric, scene, cfg, resolution, fov, offsets,
                 device="cuda"):
    """The (S, H, W) screen-azimuth grid of each pass, for the renderer.
    Under the mirror symmetry the bottom rows carry the azimuth of the
    (-dy, dx) sample they hold."""
    height = resolution[0]
    rows = height // 2 + 1 if _use_tb(scene, cfg) else height
    grid = dict(psi=scene.psi, dtype=_dtype_of(cfg), boost=scene.boost,
                device=device)
    thetas = []
    for offset in offsets:
        theta = camera.build_theta_lookup(resolution, fov,
                                          pixel_offset=tuple(offset), **grid)
        if rows < height:
            flipped = camera.build_theta_lookup(
                resolution, fov, pixel_offset=(-offset[0], offset[1]),
                **grid)
            theta = torch.cat([theta[:rows], flipped[rows:]])
        thetas.append(theta)
    return torch.stack(thetas)


def render_shadow_aa(scene: SceneConfig, resolution,
                     cfg: RenderConfig = RenderConfig(),
                     aa_samples: int = 4, mesh=None, device="cuda"):
    """Anti-aliased integrated shadow; returns (image (H, W) float32 on
    `device`, stats).

    The shadow boundary gets coverage values k / aa_samples instead of
    binary aliasing.
    """
    _check_mesh(mesh)
    metric = scene.metric()
    timer = StageTimer(device)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    offsets = aa_offsets(aa_samples)

    with timer.stage("precompute"):
        fa, _nh, _st, traced = _trace_all_passes(
            metric, scene, cfg, resolution, fov, offsets, device)
        # Escaped samples of each pixel, summed in float64 and rounded
        # once, as the JAX package averages them.
        acc = (~torch.isnan(fa)).to(torch.float64).sum(dim=0)
    with timer.stage("render"):
        img = (acc / aa_samples).to(torch.float32)

    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device),
        total_rays=resolution[0] * resolution[1] * aa_samples,
        traced_rays=traced,
        aa_samples=aa_samples,
        n_devices=1,
        timings=timer.finish())
    return img, stats


def render_scene_aa(scene: SceneConfig, source_image,
                    cfg: RenderConfig = RenderConfig(),
                    aa_samples: int = 4, mesh=None, device="cuda"):
    """Anti-aliased lensed render; returns (image in the source's shape
    and float dtype on `device`, stats). Each pass is rendered to colours
    and the colours are averaged."""
    _check_mesh(mesh)
    metric = scene.metric()
    timer = StageTimer(device)
    src = _source_tensor(source_image, device)
    resolution = tuple(src.shape[:2])
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    offsets = aa_offsets(aa_samples)
    alpha_crit = metric.alpha_crit(scene.r_obs, device=device)

    acc = torch.zeros(src.shape, dtype=src.dtype, device=src.device)
    with timer.stage("precompute+render"):
        fa_s, nh_s, _st, traced = _trace_all_passes(
            metric, scene, cfg, resolution, fov, offsets, device)
        theta_s = _pass_thetas(metric, scene, cfg, resolution, fov,
                               offsets, device)
        for i in range(len(offsets)):
            acc = acc + render_lensed_image(
                src, None, fa_s[i], nh_s[i], alpha_crit, fov,
                cfg.render_loop_around, psi=scene.psi,
                theta_lookup=theta_s[i], sampling=cfg.sampling)

    img = (acc / aa_samples).to(src.dtype)
    stats = dict(
        total_rays=resolution[0] * resolution[1] * aa_samples,
        traced_rays=traced,
        aa_samples=aa_samples,
        n_devices=1,
        timings=timer.finish())
    return img, stats
