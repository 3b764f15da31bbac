"""Frame sequences: camera pans, spin/mass sweeps and observer flybys.

The counterpart of `light_path_tracer_tpu.sequence`. There the camera
pointing, the metric's (M, a) and the observer's radius and velocity are
traced arguments of one compiled program, so a sequence compiles once.
Here nothing compiles per frame: each frame builds its camera grids in
float32 on the device (camera.build_angle_lookups_dynamic: no mirror fold,
no axis-refine band) and traces them through the hybrid tracer (the mu
chart in bulk, the rays near the polar axis re-traced in theta) with
`pass1_steps=512`: on a CUDA device the CUDA hybrid over the Kerr kernel
(ops/cuda/kerr_trace_kernel.py), whose run-time (M, a) and (M, a, r_obs)
are kernel arguments (`dynamic_params`), on the CPU the plain loop with
the JAX package's XLA semantics. The counterpart of JAX's one-compile
guarantee is that every frame of a sequence makes the same launches and
builds nothing: `frame_stats` receives each frame's launch count and time.

Shadow frames are float32 {0, 1} (0 where the ray did not escape);
lensed frames go through render._render_core with the frame's float32
camera basis. Charged scenes run `render_sequence` with the static
Kerr-Newman metric; the run-time metric is uncharged Kerr (TracedKerr),
so charged spin sweeps and flybys raise, as in the JAX package.
"""

from __future__ import annotations

import time

import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.disk import _scene_metric
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.pipeline import _source_tensor
from light_path_tracer_tpu_torch.render import _render_core
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

# The hybrid's first-pass cap on the card, as in the JAX package's
# sequences: a photon-ring grazer can need thousands of attempts, and the
# capped mu pass plus the full-depth theta re-trace keeps every frame
# near the median cost.
PASS1_STEPS = 512


def launch_count() -> int:
    """Kerr trace launches so far: every counter of the CUDA Kerr wrapper
    plus the plain loop's calls."""
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    fn = kk.trace_rays_kerr_cuda
    return kerr_trace.trace_rays_kerr.launches + sum(
        getattr(fn, kk.counter_name(dtype, method, chart))
        for dtype in (torch.float32, torch.float64)
        for method in ("dp45", "dop853") for chart in kk.VARIANTS)


def _hybrid(alphas):
    """The hybrid tracer of the rays' device: the CUDA driver (the JAX
    Pallas backend's semantics) or the plain loop (its XLA backend's)."""
    if alphas.device.type == "cuda":
        from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
            trace_rays_kerr_hybrid)
    else:
        from light_path_tracer_tpu_torch.ops.kerr_trace import (
            trace_rays_kerr_hybrid)
    return trace_rays_kerr_hybrid


def _source(source_image, resolution, device):
    """(source tensor or None, frame resolution): uint8 becomes float32 /
    255; a shadow sequence needs `resolution`."""
    if source_image is None:
        if resolution is None:
            raise ValueError("resolution required for shadow sequences")
        return None, (int(resolution[0]), int(resolution[1]))
    src = _source_tensor(source_image, device)
    return src, (int(src.shape[0]), int(src.shape[1]))


def _frame(metric, r_obs, theta_obs, psi, resolution, fov, src, *,
           lambda_max, max_steps, loop_around, device, dynamic_params=None,
           boost=None, boost_dynamic=None):
    """One frame: float32 grids at psi, the hybrid trace, then the shadow
    mask or the lensed image."""
    alpha, theta = camera.build_angle_lookups_dynamic(
        resolution, fov, psi[0], psi[1], dtype=torch.float32, boost=boost,
        boost_dynamic=boost_dynamic, device=device)
    al = alpha.reshape(-1)
    kw = {} if dynamic_params is None else dict(dynamic_params=dynamic_params)
    res = _hybrid(al)(metric, r_obs, al, theta.reshape(-1), theta_obs,
                      torch.zeros(al.shape, dtype=torch.bool, device=device),
                      lambda_max, max_steps, pass1_steps=PASS1_STEPS, **kw)
    fa = res.final_alpha.reshape(resolution)
    if src is None:
        return torch.where(torch.isnan(fa), 0.0, 1.0).to(torch.float32)
    winding = torch.clamp(res.n_half_orbits, 0, 65535).reshape(resolution)
    d, e_x, e_y = camera.psi_frame_dynamic(psi[0], psi[1], torch.float32)
    return _render_core(src, theta, fa, winding, d, e_x, e_y, resolution,
                        fov, loop_around)


def _run(frames, render_one, device, frame_stats):
    """Render each frame; with `frame_stats` (a list) append one dict a
    frame: its Kerr launches and its time in ms (the device synchronised
    at the frame's end)."""
    out = []
    dev = torch.device(device)
    for f in frames:
        n0, t0 = launch_count(), time.perf_counter()
        out.append(render_one(f))
        if frame_stats is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            frame_stats.append(dict(
                launches=launch_count() - n0,
                ms=1e3 * (time.perf_counter() - t0)))
    return out


def _boost3(boost):
    return tuple(float(b) for b in boost)


def render_sequence(scene: SceneConfig, psi_frames, source_image=None,
                    resolution=None, cfg: RenderConfig = RenderConfig(),
                    max_steps: int = 20000, device="cuda",
                    frame_stats: list | None = None):
    """Frames for a sequence of (psi_y, psi_x) camera pointings.

    source_image=None renders binary shadows (resolution required);
    otherwise lensed frames at the source image's resolution. The scene's
    metric (Kerr, or Kerr-Newman when charged) and its static r_obs and
    boost serve every frame. Returns a list of tensors on `device`.
    """
    metric = _scene_metric(scene)
    src, resolution = _source(source_image, resolution, device)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    kw = dict(lambda_max=max(5000.0, 6.0 * scene.r_obs), max_steps=max_steps,
              loop_around=cfg.render_loop_around, device=device,
              boost=_boost3(scene.boost))
    return _run(psi_frames, lambda psi: _frame(
        metric, scene.r_obs, scene.theta_obs, psi, resolution, fov, src,
        **kw), device, frame_stats)


def render_param_sequence(scene: SceneConfig, frames, resolution,
                          max_steps: int = 20000, device="cuda",
                          frame_stats: list | None = None):
    """Shadow frames over a sequence of (psi_y, psi_x, M, a): the camera
    and the metric's parameters change each frame, the launches stay the
    same (a spin ramp 0 -> 0.99 traces through the kernel's run-time
    (M, a))."""
    if getattr(scene, "Q", 0.0):
        raise ValueError(
            "render_param_sequence traces (M, a) through TracedKerr, which "
            "is uncharged; charged sweeps are not supported - use "
            "render_sequence (static Kerr-Newman metric) instead")
    resolution = (int(resolution[0]), int(resolution[1]))
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    placeholder = Kerr(M=1.0, a=0.0)
    kw = dict(lambda_max=max(5000.0, 6.0 * scene.r_obs), max_steps=max_steps,
              loop_around=False, device=device, boost=_boost3(scene.boost))
    return _run(frames, lambda f: _frame(
        placeholder, scene.r_obs, scene.theta_obs, (f[0], f[1]), resolution,
        fov, None, dynamic_params=(f[2], f[3]), **kw), device, frame_stats)


def render_flyby(scene: SceneConfig, frames, source_image=None,
                 resolution=None, cfg: RenderConfig = RenderConfig(),
                 max_steps: int = 20000, device="cuda",
                 frame_stats: list | None = None):
    """Flyby / approach sequences: frames that vary the observer's radius
    and velocity as well as the camera pointing.

    frames: iterable of (r_obs, boost) or (psi_y, psi_x, r_obs, boost),
    boost a 3-vector in units of c (camera coords: +x right, +y down, +z
    forward; (0, 0, b) flies toward the hole, and the shadow shrinks by
    aberration even as the approach grows it). Omitted psi uses
    scene.psi. source_image=None renders binary shadows (resolution
    required); otherwise lensed frames at the source's resolution. The
    radius enters the trace as run-time (M, a, r_obs) (escape radius and
    first step follow it each frame), the boost through
    camera.aberrate_view_dynamic; lambda_max is max(5000, 6 max r_obs)
    over the whole sweep.
    """
    if getattr(scene, "Q", 0.0):
        raise ValueError(
            "render_flyby traces the metric through TracedKerr, which is "
            "uncharged; charged flybys are not supported - use "
            "render_sequence (static Kerr-Newman metric) instead")
    norm = []
    for f in frames:
        if len(f) == 2:
            r_o, boost = f
            psi_y, psi_x = scene.psi
        else:
            psi_y, psi_x, r_o, boost = f
        bx, by, bz = _boost3(boost)
        if bx * bx + by * by + bz * bz >= 1.0:
            raise ValueError("|boost| must be < 1 (units of c)")
        norm.append((float(psi_y), float(psi_x), float(r_o), (bx, by, bz)))
    if not norm:
        return []
    lambda_max = max(5000.0, 6.0 * max(f[2] for f in norm))
    src, resolution = _source(source_image, resolution, device)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    placeholder = Kerr(M=1.0, a=0.0)
    kw = dict(lambda_max=lambda_max, max_steps=max_steps,
              loop_around=cfg.render_loop_around, device=device)
    return _run(norm, lambda f: _frame(
        placeholder, 100.0, scene.theta_obs, (f[0], f[1]), resolution, fov,
        src, dynamic_params=(scene.M, scene.a, f[2]), boost_dynamic=f[3],
        **kw), device, frame_stats)
