"""Adaptive supersampling: refine only the pixels where AA matters.

The counterpart of `light_path_tracer_tpu.adaptive`. In a lensed
black-hole scene the features that alias lie on a set of measure zero
(the shadow boundary, the photon rings, the high-magnification band
around the critical curve); elsewhere one sample a pixel already equals
the converged average. So:

  1. Base pass: one full-grid trace at the first AA offset (aa.py's
     pattern, so refined pixels end up with the full AA sample set).
  2. Edge score: a per-pixel priority from the base pass alone; capture
     flips outrank winding changes, which outrank the final-alpha
     gradient (plus colour contrast in the lensed render).
  3. Compaction: the `refine_frac * H * W` highest scores. Scores are
     full of exact ties, so the pick is a stable descending sort, which
     takes ties in ascending index order as the JAX package's
     `lax.top_k` does; `torch.topk` guarantees no order among ties.
  4. Refine pass: the remaining aa_samples - 1 samples are traced for
     those pixels only (camera.pixel_angles_at) and averaged into the
     base image.

Refined pixels carry exactly the sample set uniform AA gives them;
unrefined ones keep their single sample. Cost: H*W + (S-1)*K rays
against S*H*W. Both passes take the two-pass straggler driver on the
card ("auto" resolves to on: subpixel grids are jittered, so near-axis
stragglers come at any batch size). Both trace with cfg.integrator and
cfg.event_interp, as aa.py does (the JAX package's adaptive passes
neither), and in the theta chart whatever cfg.formulation says, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.aa import _mirror_fill, aa_offsets
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.pipeline import (_dtype_of, _source_tensor,
                                                  _use_tb)
from light_path_tracer_tpu_torch.render import render_lensed_image
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer

# Score weights: a capture flip must outrank any winding change, which
# must outrank any smooth final-alpha gradient (|d alpha| <= pi) or
# colour contrast (<= sqrt(3)). Only the order matters.
_W_CAPTURE = 1e6
_W_WINDING = 1e3


def _neighbor_max_diff(x):
    """Max |difference to a 4-neighbour| per pixel, edge-replicated."""
    dy = torch.abs(x[1:] - x[:-1])
    dx = torch.abs(x[:, 1:] - x[:, :-1])
    d = torch.zeros_like(x)
    d[1:, :] = torch.maximum(d[1:, :], dy)
    d[:-1, :] = torch.maximum(d[:-1, :], dy)
    d[:, 1:] = torch.maximum(d[:, 1:], dx)
    d[:, :-1] = torch.maximum(d[:, :-1], dx)
    return d


def edge_score(final_alpha, winding, base_image=None):
    """Per-pixel refinement priority from a single-sample pass.

    Capture-boundary flips > winding transitions > final-alpha gradient
    (+ colour contrast when a rendered base image is given). Returns a
    float32 (H, W) tensor; zero means no 4-neighbour disagrees in any
    channel.
    """
    captured = torch.isnan(final_alpha)
    cap = captured.to(torch.float32)
    fa = torch.where(captured, torch.zeros_like(final_alpha),
                     final_alpha).to(torch.float32)
    score = (_W_CAPTURE * _neighbor_max_diff(cap)
             + _W_WINDING * _neighbor_max_diff(winding.to(torch.float32))
             + _neighbor_max_diff(fa))
    if base_image is not None:
        img = base_image if base_image.dim() == 3 else base_image[..., None]
        contrast = torch.stack(
            [_neighbor_max_diff(img[..., c].to(torch.float32))
             for c in range(img.shape[2])]).amax(dim=0)
        score = score + contrast
    return score


def _refine_budget(resolution, refine_frac):
    n_px = resolution[0] * resolution[1]
    return int(np.clip(int(refine_frac * n_px), 1, n_px))


def _check_samples(aa_samples):
    if aa_samples < 2:
        raise ValueError(
            f"adaptive AA needs aa_samples >= 2, got {aa_samples}")


def _top_k(score, k):
    """Indices of the k highest scores of the flattened score, ties in
    ascending index order (lax.top_k's order)."""
    return torch.sort(score.reshape(-1), descending=True,
                      stable=True).indices[:k]


def _refine_angles(idx, resolution, fov, offsets, scene, dtype):
    """(alpha, theta) of the S-1 refinement samples at the gathered
    pixels; both shaped (S-1, K)."""
    width = resolution[1]
    py, px = idx // width, idx % width
    alphas, thetas = [], []
    for off in offsets[1:]:
        al, th = camera.pixel_angles_at(
            py, px, resolution, fov, psi=scene.psi, dtype=dtype,
            pixel_offset=tuple(off), boost=scene.boost)
        alphas.append(al)
        thetas.append(th)
    return torch.stack(alphas), torch.stack(thetas)


def _two_pass(cfg):
    # "auto" resolves to on: jittered grids make near-axis stragglers
    # certain at any batch size.
    return True if cfg.two_pass == "auto" else cfg.two_pass


def _trace(metric, scene, cfg, alphas, thetas):
    return trace_batch(
        metric, scene.r_obs, alphas.reshape(-1),
        None if thetas is None else thetas.reshape(-1), scene.theta_obs,
        max_steps=cfg.max_steps, backend=cfg.backend,
        integrator=cfg.integrator, event_interp=cfg.event_interp,
        precision=cfg.precision, two_pass=_two_pass(cfg),
        pass1_steps=cfg.pass1_steps)


def render_shadow_adaptive(scene: SceneConfig, resolution,
                           cfg: RenderConfig = RenderConfig(),
                           aa_samples: int = 4, refine_frac: float = 0.05,
                           device="cuda"):
    """Adaptively anti-aliased integrated shadow; returns (image (H, W)
    float32 on `device`, stats).

    Equal to render_shadow_aa wherever the budget covers the edge set
    (the shadow boundary is O(perimeter), ~4/H of the pixels). Under the
    mirror symmetry (aa.py's rule) the base pass traces rows 0..H//2 and
    mirror-fills, the edge score folds onto the traced rows (a bottom
    edge marks its top twin), and each refined top pixel's coverage is
    written to both twins: the twin's sample set is the flipped-offset
    one, equal by the scene's symmetry.
    """
    _check_samples(aa_samples)
    metric = scene.metric()
    timer = StageTimer(device)
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    offsets = aa_offsets(aa_samples)
    dtype = _dtype_of(cfg)
    k = _refine_budget(resolution, refine_frac)
    use_tb = _use_tb(scene, cfg)
    trace_rows = height // 2 + 1 if use_tb else height
    grid = dict(psi=scene.psi, dtype=dtype, boost=scene.boost,
                pixel_offset=tuple(offsets[0]), device=device)

    with timer.stage("precompute"):
        alpha0 = camera.build_alpha_lookup(resolution, fov, **grid)
        theta0 = (None if metric.is_spherically_symmetric else
                  camera.build_theta_lookup(resolution, fov, **grid))
        res0 = _trace(metric, scene, cfg, alpha0[:trace_rows],
                      None if theta0 is None else theta0[:trace_rows])
        fa0 = res0.final_alpha.reshape(trace_rows, width)
        nh0 = res0.n_half_orbits.reshape(trace_rows, width)
        if use_tb:
            fa0 = _mirror_fill(fa0[None], height)[0]
            nh0 = _mirror_fill(nh0[None], height)[0]

    with timer.stage("refine"):
        score = edge_score(fa0, nh0)
        if use_tb:
            # The twin of traced row r is row H - r (row 0 and, for even
            # H, row H//2 are their own twins).
            rows = torch.arange(trace_rows, device=score.device)
            score_fold = torch.maximum(score[rows],
                                       score[(height - rows) % height])
            idx = _top_k(score_fold, k)
        else:
            idx = _top_k(score, k)
        al_r, th_r = _refine_angles(idx, resolution, fov, offsets, scene,
                                    dtype)
        res_r = _trace(metric, scene, cfg, al_r,
                       None if theta0 is None else th_r)
        # NaN final_alpha = captured (render_shadow_aa's coverage rule).
        cov_r = (~torch.isnan(res_r.final_alpha)).reshape(
            aa_samples - 1, k).to(torch.float32).sum(dim=0)

    with timer.stage("render"):
        img = (~torch.isnan(fa0)).to(torch.float32).reshape(-1)
        refined = (img[idx] + cov_r) / aa_samples
        img[idx] = refined
        if use_tb:
            py, px = idx // width, idx % width
            img[((height - py) % height) * width + px] = refined
        img = img.reshape(resolution)

    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device),
        total_rays=trace_rows * width + (aa_samples - 1) * k,
        traced_rays=trace_rows * width + (aa_samples - 1) * k,
        uniform_aa_rays=height * width * aa_samples,
        refined_pixels=k,
        refined_idx=idx,
        tb_symmetry=use_tb,
        edge_pixels=int((score >= _W_WINDING).sum()),
        aa_samples=aa_samples,
        refine_frac=refine_frac,
        timings=timer.finish())
    return img, stats


def render_scene_adaptive(scene: SceneConfig, source_image,
                          cfg: RenderConfig = RenderConfig(),
                          aa_samples: int = 4, refine_frac: float = 0.05,
                          device="cuda"):
    """Adaptively anti-aliased lensed render; returns (image in the
    source's shape and float dtype on `device`, stats).

    The edge score adds the base image's local colour contrast, so
    strongly sheared texture near the critical curve refines even where
    the winding count is flat. Each sample is a rendered colour, averaged
    as render_scene_aa averages them.
    """
    _check_samples(aa_samples)
    metric = scene.metric()
    timer = StageTimer(device)
    src = _source_tensor(source_image, device)
    resolution = tuple(src.shape[:2])
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    offsets = aa_offsets(aa_samples)
    dtype = _dtype_of(cfg)
    n_px = resolution[0] * resolution[1]
    k = _refine_budget(resolution, refine_frac)
    alpha_crit = metric.alpha_crit(scene.r_obs, device=device)
    symmetric = metric.is_spherically_symmetric
    grid = dict(psi=scene.psi, dtype=dtype, boost=scene.boost,
                pixel_offset=tuple(offsets[0]), device=device)

    def render(alphas, fa, nh, thetas):
        return render_lensed_image(
            src, alphas, fa.to(torch.float32),
            torch.clamp(nh, 0, cfg.winding_max), alpha_crit, fov,
            cfg.render_loop_around, psi=scene.psi, theta_lookup=thetas,
            sampling=cfg.sampling)

    with timer.stage("precompute"):
        alpha0 = camera.build_alpha_lookup(resolution, fov, **grid)
        theta0 = camera.build_theta_lookup(resolution, fov, **grid)
        res0 = _trace(metric, scene, cfg, alpha0,
                      None if symmetric else theta0)
        fa0 = res0.final_alpha.reshape(resolution)
        nh0 = res0.n_half_orbits.reshape(resolution)

    with timer.stage("render"):
        base = render(alpha0, fa0, nh0, theta0)

    with timer.stage("refine"):
        score = edge_score(fa0, nh0, base)
        idx = _top_k(score, k)
        al_r, th_r = _refine_angles(idx, resolution, fov, offsets, scene,
                                    dtype)
        res_r = _trace(metric, scene, cfg, al_r,
                       None if symmetric else th_r)
        # The renderer is elementwise in its lookups, so the (S-1, K)
        # samples render as one "image".
        colors_r = render(
            al_r, res_r.final_alpha.reshape(aa_samples - 1, k),
            res_r.n_half_orbits.reshape(aa_samples - 1, k), th_r)
        base_flat = base.reshape(n_px, -1)
        col_r = colors_r.reshape(aa_samples - 1, k, -1)
        refined = (base_flat[idx] + col_r.sum(dim=0)) / aa_samples
        img_flat = base_flat.clone()
        img_flat[idx] = refined.to(base.dtype)
        img = img_flat.reshape(base.shape)

    stats = dict(
        alpha_crit=alpha_crit,
        total_rays=n_px + (aa_samples - 1) * k,
        traced_rays=n_px + (aa_samples - 1) * k,
        uniform_aa_rays=n_px * aa_samples,
        refined_pixels=k,
        refined_idx=idx,
        edge_pixels=int((score >= _W_WINDING).sum()),
        aa_samples=aa_samples,
        refine_frac=refine_frac,
        timings=timer.finish())
    return img, stats
