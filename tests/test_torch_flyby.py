"""The port's flybys (sequence.render_flyby) against the JAX package.

The observer's radius and velocity change each frame: the radius enters
the trace as run-time (M, a, r_obs), the boost goes through
camera.aberrate_view_dynamic. Both packages capped at 64 attempts a ray,
as in tests/test_torch_sequence.py (which holds the camera, the pans, the
spin sweeps and the CLI):
  * an approach 100 -> 60 -> 30 M with a 0.5 c boost on the last frame,
    16^2 shadows: masks equal on >= 99 % of pixels (measured 100 %); the
    same launches every frame (2: the hybrid's two passes); the approach
    grows the shadow and the boost shrinks it; the rest-frame frame
    equals render_sequence's (the run-time float32 r_obs = 100 forms the
    static first step and radii);
  * lensed flyby frames (a 12 x 16 source, per-frame psi): image RMSE
    within 1e-3 of JAX (measured 0).
"""

import numpy as np
import torch
import pytest

from light_path_tracer_tpu import sequence as jseq
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import sequence
from light_path_tracer_tpu_torch.convert import scene_from_jax

STEPS = 64
SCENE = JScene(M=1.0, a=0.9, r_obs_mult=100.0)
FLYBY = [(100.0, (0, 0, 0.0)), (60.0, (0, 0, 0.0)), (30.0, (0, 0, 0.0)),
         (30.0, (0, 0, 0.5))]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mask_agree(ref, got):
    return [float((np.asarray(r) == _np(g)).mean()) for r, g in zip(ref, got)]


def test_flyby_matches_jax():
    ref = jseq.render_flyby(SCENE, FLYBY, resolution=(16, 16),
                            max_steps=STEPS)
    stats = []
    got = sequence.render_flyby(scene_from_jax(SCENE), FLYBY,
                                resolution=(16, 16), max_steps=STEPS,
                                device="cpu", frame_stats=stats)
    assert min(_mask_agree(ref, got)) >= 0.99, _mask_agree(ref, got)
    assert [s["launches"] for s in stats] == [2] * len(FLYBY)
    px = [int((1.0 - _np(f)).sum()) for f in got]
    assert px[0] < px[1] < px[2] and px[3] < px[2], px
    seq = sequence.render_sequence(scene_from_jax(SCENE), [(0.0, 0.0)],
                                   resolution=(16, 16), max_steps=STEPS,
                                   device="cpu")
    assert torch.equal(got[0], seq[0])


def test_lensed_flyby_matches_jax():
    src = np.random.default_rng(1).random((12, 16, 3)).astype(np.float32)
    scene = JScene(M=1.0, a=0.6, r_obs_mult=100.0)
    frames = [(0.0, 0.0, 100.0, (0, 0, 0.0)), (0.01, 0.0, 50.0, (0, 0, 0.3))]
    ref = jseq.render_flyby(scene, frames, source_image=src, max_steps=STEPS)
    got = sequence.render_flyby(scene_from_jax(scene), frames,
                                source_image=src, max_steps=STEPS,
                                device="cpu")
    for r, g in zip(ref, got):
        assert tuple(g.shape) == src.shape and bool(torch.isfinite(g).all())
        rmse = float(np.sqrt(((np.asarray(r) - _np(g)) ** 2).mean()))
        assert rmse < 1e-3, rmse
