"""The port's frame sequences (sequence.py, cli/animate.py) against the JAX
package.

Inputs are made from seeds with numpy and go through the JAX package on
the CPU (its sequences on the XLA backend) and the port's plain loop:
  * the run-time camera: psi_frame_dynamic and build_angle_lookups_dynamic
    (with no boost, a static boost and a per-frame boost) in float64 within
    1e-12 of JAX (measured 1.2e-14); in float32 within 1e-4 rad in alpha
    and 5e-5 in theta (measured 3.1e-5 and 1.6e-5: the port computes the
    grids in float32 throughout, JAX under x64 promotes them through its
    float64 focal lengths, and arccos is ill-conditioned near the hole's
    direction); aberrate_view_dynamic within 1e-12 of aberrate_view in
    float64, and b = 0 the identity;
  * render_sequence (a pan, shadow and lensed) and render_param_sequence
    (a spin ramp) at 16-20 px (render_flyby: tests/test_torch_flyby.py),
    both packages capped at 64 attempts a ray
    (the plain mu chart grinds rays beside the pole to the cap, ~8 ms an
    attempt at 24^2 on the CPU): shadow masks equal on >= 99 % of pixels
    (measured 100 %), lensed frames within image RMSE 1e-3 (measured 0);
    every frame makes the same launches (2: the hybrid's two passes);
    the spin ramp agrees with the port's static render_shadow (mirror
    fold off) on > 99 % of pixels, JAX's own bar;
  * charged flybys and spin sweeps and a superluminal boost raise
    ValueError, as in the JAX package;
  * `animate` end to end on the CPU, a pan and a flyby: PNG frames, the
    .npz, the summary line.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import camera as jcamera
from light_path_tracer_tpu import sequence as jseq
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import camera, sequence
from light_path_tracer_tpu_torch.cli import main as cli_main
from light_path_tracer_tpu_torch.convert import scene_from_jax
from light_path_tracer_tpu_torch.pipeline import render_shadow
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

STEPS = 64
SCENE = JScene(M=1.0, a=0.9, r_obs_mult=100.0)
PAN = [(0.0, 0.0), (0.0, 0.01), (0.005, -0.01)]
SPINS = [0.0, 0.5, 0.9]
DIM = (40, 56)
FOV = jcamera.fov_from_vertical(np.radians(35.0), DIM)
BOOST = (0.1, -0.2, 0.3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- the run-time camera ----

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("psi", [(0.0, 0.0), (0.05, -0.08), (0.0, 0.3)])
def test_psi_frame_dynamic(psi, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jcamera.psi_frame_dynamic(jnp.asarray(psi[0], jd),
                                    jnp.asarray(psi[1], jd))
    got = camera.psi_frame_dynamic(*psi, dtype=td)
    tol = 1e-7 if dtype == "float32" else 1e-15
    for r, g in zip(ref, got):
        assert g.dtype == td
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0, atol=tol)


@pytest.mark.parametrize("boost", ["none", "static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("psi", [(0.0, 0.0), (0.05, -0.08)])
def test_angle_lookups_dynamic(psi, dtype, boost):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jkw, tkw = {}, {}
    if boost == "static":
        jkw = tkw = dict(boost=BOOST)
    elif boost == "dynamic":
        jkw = dict(boost_dynamic=tuple(jnp.asarray(b, jd) for b in BOOST))
        tkw = dict(boost_dynamic=BOOST)
    a_j, t_j = jcamera.build_angle_lookups_dynamic(
        DIM, FOV, jnp.asarray(psi[0], jd), jnp.asarray(psi[1], jd),
        dtype=jd, **jkw)
    a_t, t_t = camera.build_angle_lookups_dynamic(
        DIM, FOV, psi[0], psi[1], dtype=td, device="cpu", **tkw)
    assert a_t.dtype == td and tuple(a_t.shape) == DIM
    tol_a, tol_t = (1e-4, 5e-5) if dtype == "float32" else (1e-12, 1e-12)
    np.testing.assert_allclose(_np(a_t), np.asarray(a_j), rtol=0, atol=tol_a)
    np.testing.assert_allclose(_np(t_t), np.asarray(t_j), rtol=0, atol=tol_t)


def test_aberrate_view_dynamic_matches_static():
    vx, vy, vz = camera._view_grids_in(DIM, FOV, torch.float64, "cpu")
    ref = camera.aberrate_view(vx, vy, vz, BOOST)
    got = camera.aberrate_view_dynamic(vx, vy, vz, *BOOST)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_np(g), _np(r), rtol=0, atol=1e-12)
    for r, g in zip((vx, vy, vz),
                    camera.aberrate_view_dynamic(vx, vy, vz, 0.0, 0.0, 0.0)):
        assert torch.equal(r, g)


# ---- the sequences against the JAX package ----

@functools.lru_cache(maxsize=None)
def _pan():
    ref = jseq.render_sequence(SCENE, PAN, resolution=(16, 16),
                               max_steps=STEPS)
    stats = []
    got = sequence.render_sequence(scene_from_jax(SCENE), PAN,
                                   resolution=(16, 16), max_steps=STEPS,
                                   device="cpu", frame_stats=stats)
    return ref, got, stats


def _mask_agree(ref, got):
    return [float((np.asarray(r) == _np(g)).mean()) for r, g in zip(ref, got)]


def test_shadow_pan_matches_jax():
    ref, got, stats = _pan()
    assert len(got) == len(PAN)
    for g in got:
        img = _np(g)
        assert img.shape == (16, 16) and img.dtype == np.float32
        assert set(np.unique(img)) <= {0.0, 1.0} and (img == 0).sum() > 0
    assert min(_mask_agree(ref, got)) >= 0.99, _mask_agree(ref, got)
    # the same launches every frame: the hybrid's two passes
    assert [s["launches"] for s in stats] == [2] * len(PAN)
    c0 = np.argwhere(_np(got[0]) == 0).mean(0)
    c1 = np.argwhere(_np(got[1]) == 0).mean(0)
    assert abs(c1[1] - c0[1]) > 0.1       # the pan moves the shadow


def test_lensed_pan_matches_jax():
    src = np.random.default_rng(0).random((16, 20, 3)).astype(np.float32)
    scene = JScene(M=1.0, a=0.6, r_obs_mult=100.0)
    psis = [(0.0, 0.0), (0.01, 0.0)]
    ref = jseq.render_sequence(scene, psis, src, max_steps=STEPS)
    got = sequence.render_sequence(scene_from_jax(scene), psis, src,
                                   max_steps=STEPS, device="cpu")
    for r, g in zip(ref, got):
        assert tuple(g.shape) == src.shape and bool(torch.isfinite(g).all())
        rmse = float(np.sqrt(((np.asarray(r) - _np(g)) ** 2).mean()))
        assert rmse < 1e-3, rmse
    assert not torch.equal(got[0], got[1])


def test_spin_sweep_matches_jax_and_static():
    scene = JScene(M=1.0, a=0.0, r_obs_mult=100.0)
    frames = [(0.0, 0.0, 1.0, a) for a in SPINS]
    ref = jseq.render_param_sequence(scene, frames, (16, 16),
                                     max_steps=STEPS)
    stats = []
    got = sequence.render_param_sequence(scene_from_jax(scene), frames,
                                         (16, 16), max_steps=STEPS,
                                         device="cpu", frame_stats=stats)
    assert min(_mask_agree(ref, got)) >= 0.99, _mask_agree(ref, got)
    assert [s["launches"] for s in stats] == [2] * len(SPINS)
    for a, frame in zip(SPINS, got):
        img_ref, _ = render_shadow(
            SceneConfig(M=1.0, a=a, r_obs_mult=100.0), (16, 16),
            RenderConfig(use_tb_symmetry=False), device="cpu")
        agree = float((frame == img_ref).float().mean())
        assert agree > 0.99, (a, agree)
    assert not torch.equal(got[0], got[2])


def test_rejections():
    charged = SceneConfig(M=1.0, a=0.5, Q=0.6)
    with pytest.raises(ValueError, match="uncharged"):
        sequence.render_flyby(charged, [(100.0, (0.0, 0.0, 0.0))],
                              resolution=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="uncharged"):
        sequence.render_param_sequence(charged, [(0.0, 0.0, 1.0, 0.5)],
                                       (8, 8), device="cpu")
    with pytest.raises(ValueError, match="boost"):
        sequence.render_flyby(SceneConfig(), [(100.0, (0, 0, 1.0))],
                              resolution=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        sequence.render_sequence(SceneConfig(), [(0.0, 0.0)], device="cpu")
    assert sequence.render_flyby(SceneConfig(), [], resolution=(8, 8),
                                 device="cpu") == []


@pytest.mark.parametrize("mode", ["pan", "flyby"])
def test_animate_cli(tmp_path, capsys, mode):
    out = str(tmp_path / "a.gif")
    extra = ["--flyby", "100:40", "--boost-to", "0.3"] if mode == "flyby" \
        else ["--pan-deg", "1"]
    rc = cli_main(["animate", "--a", "0.9", "--size", "12", "--frames", "2",
                   "--max-steps", str(STEPS), "--device", "cpu",
                   "--output", out, *extra])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Animation: 2 frames at 12x12" in text and "ms/frame" in text
    assert "launches per frame: [2, 2]" in text
    for k in range(2):
        assert os.path.exists(tmp_path / f"a_{k:03d}.png")
    arr = np.load(tmp_path / "a_frames.npz")
    assert arr["frames"].shape == (2, 12, 12)
    assert list(arr["launches"]) == [2, 2]
