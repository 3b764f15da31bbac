"""The port's lookup-table checkpoints (light_path_tracer_tpu_torch.
checkpoint) against the JAX package's, on the CPU.

  * cache_key: the JAX package's hex for the same scene, render
    configuration, size and FOV, over seven configurations, and its
    sensitivity (physics changes the key, scheduling knobs do not);
  * the lookup .npz: a file written by JAX's save_lookup loads in the
    port bitwise, and the reverse;
  * cached_precompute: a hit equal to the miss bitwise, float64;
  * chunk resume: a chunked float64 precompute killed after 2 of 3
    chunks resumes from the 2 stored chunks, traces only the third, and
    equals a fresh run bitwise; the chunk files are gone afterwards;
    resume without chunking raises;
  * render sessions through torch.distributed.checkpoint: the tables
    round-trip bitwise, a mismatched configuration is refused, and an
    unverified restore works;
  * `lens --cache`: MISS then HIT, each image bitwise `lens` without the
    cache.
"""

import os

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import checkpoint as jckpt
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import camera, checkpoint as ckpt
from light_path_tracer_tpu_torch.pipeline import precompute_final_alpha
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


CONFIGS = [
    (dict(), dict(), (32, 32), (0.7, 0.7)),
    (dict(M=1.0, a=0.5), dict(dtype="float64"), (16, 20), (0.3, 0.25)),
    (dict(a=0.9, theta_obs=1.2, psi_x=0.01, psi_y=-0.02),
     dict(precision="gate", max_steps=1234), (24, 32), (0.5, 0.4)),
    (dict(a=0.6, Q=0.4, r_obs_mult=50.0, vertical_fov_deg=30.0),
     dict(integrator="dop853", event_interp="linear"), (8, 8), (1.0, 1.0)),
    (dict(a=0.9, eps3=2.0, boost=(0.0, 0.0, 0.3)),
     dict(formulation="mu", two_pass=True, pass1_steps=64), (64, 48),
     (0.2, 0.3)),
    (dict(a=0.3), dict(chunk_size=128, sort_by_difficulty=False,
                       progress="live", render_loop_around=True),
     (10, 12), (0.6, 0.5)),
    (dict(a=0.99, r_obs_mult=1000.0), dict(sampling="bilinear",
                                           winding_max=7), (5, 7),
     (0.01, 0.02)),
]


@pytest.mark.parametrize("index", range(len(CONFIGS)))
def test_cache_key_is_jax_hex(index):
    scene, cfg, dim, fov = CONFIGS[index]
    key = ckpt.cache_key(SceneConfig(**scene), RenderConfig(**cfg), dim, fov)
    assert len(key) == 16
    assert key == jckpt.cache_key(JScene(**scene), JRender(**cfg), dim, fov)


def test_cache_key_sensitivity():
    scene, cfg, dim, fov = SceneConfig(M=1.0, a=0.5), RenderConfig(), \
        (32, 32), (0.7, 0.7)
    k0 = ckpt.cache_key(scene, cfg, dim, fov)
    assert k0 == ckpt.cache_key(scene, cfg, dim, fov)
    assert k0 != ckpt.cache_key(SceneConfig(M=1.0, a=0.6), cfg, dim, fov)
    assert k0 != ckpt.cache_key(scene, RenderConfig(dtype="float64"), dim,
                                fov)
    assert k0 != ckpt.cache_key(scene, cfg, (64, 64), fov)
    assert k0 != ckpt.cache_key(scene, cfg, dim, (0.8, 0.7))
    for knob in (dict(render_loop_around=True), dict(progress="live"),
                 dict(chunk_size=64), dict(sort_by_difficulty=False)):
        assert k0 == ckpt.cache_key(scene, RenderConfig(**knob), dim, fov)


def _tables():
    rng = np.random.default_rng(0)
    fa = rng.random((8, 9)).astype(np.float32)
    fa[0, 0] = fa[3, 4] = np.nan
    w = rng.integers(0, 65536, (8, 9)).astype(np.uint16)
    return fa, w


def test_lookup_files_cross_the_packages(tmp_path):
    fa, w = _tables()
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_lookup(jpath, fa, w, {"traced_rays": 72})
    fa_t, w_t, meta = ckpt.load_lookup(jpath)
    assert fa_t.dtype == torch.float32 and w_t.dtype == torch.uint16
    np.testing.assert_array_equal(fa_t.numpy(), fa)
    np.testing.assert_array_equal(w_t.to(torch.int32).numpy(), w)
    assert meta == {"traced_rays": 72}

    tpath = str(tmp_path / "sub" / "port.npz")
    ckpt.save_lookup(tpath, torch.from_numpy(fa), torch.from_numpy(w),
                     {"traced_rays": 72})
    fa_j, w_j, meta_j = jckpt.load_lookup(tpath)
    np.testing.assert_array_equal(np.asarray(fa_j), fa)
    assert np.asarray(w_j).dtype == np.uint16
    np.testing.assert_array_equal(np.asarray(w_j), w)
    assert meta_j == {"traced_rays": 72}
    with np.load(tpath) as z:
        assert sorted(z.files) == ["final_alpha", "meta", "winding"]
        assert z["final_alpha"].dtype == np.float32
        assert z["winding"].dtype == np.uint16

    assert ckpt.load_lookup(str(tmp_path / "missing.npz")) is None
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    assert ckpt.load_lookup(str(bad)) is None


SCENE = SceneConfig(M=1.0, a=0.7, r_obs_mult=100.0)


def _same(a, b):
    np.testing.assert_array_equal(a.final_alpha.numpy(),
                                  b.final_alpha.numpy())
    assert torch.equal(a.winding.to(torch.int32), b.winding.to(torch.int32))


def test_cached_precompute_hit_matches_miss(tmp_path):
    cfg = RenderConfig(dtype="float64")
    dim = (16, 20)
    fov = camera.fov_from_vertical(SCENE.vertical_fov, dim)
    pre1, hit1 = ckpt.cached_precompute(SCENE, cfg, dim, fov,
                                        cache_dir=str(tmp_path),
                                        device="cpu")
    pre2, hit2 = ckpt.cached_precompute(SCENE, cfg, dim, fov,
                                        cache_dir=str(tmp_path),
                                        device="cpu")
    assert not hit1 and hit2
    _same(pre1, pre2)
    assert pre2.winding.dtype == torch.uint16
    assert (pre2.total_rays, pre2.traced_rays, pre2.steps) == (
        pre1.total_rays, pre1.traced_rays, pre1.steps)
    _pre3, hit3 = ckpt.cached_precompute(
        SceneConfig(M=1.0, a=0.71, r_obs_mult=100.0), cfg, dim, fov,
        cache_dir=str(tmp_path), device="cpu")
    assert not hit3


def test_chunk_resume_after_crash(tmp_path, monkeypatch):
    cfg = RenderConfig(dtype="float64", chunk_size=128, max_steps=20000)
    # 24 x 32, the mirror fold traces 12 rows: 384 rays, 3 chunks of 128.
    dim = (24, 32)
    fov = camera.fov_from_vertical(SCENE.vertical_fov, dim)

    class CrashingStore(ckpt.ChunkStore):
        puts = 0

        def put(self, start, res):
            super().put(start, res)
            CrashingStore.puts += 1
            if CrashingStore.puts >= 2:
                raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(ckpt, "ChunkStore", CrashingStore)
    with pytest.raises(KeyboardInterrupt):
        ckpt.cached_precompute(SCENE, cfg, dim, fov, cache_dir=str(tmp_path),
                               resume=True, device="cpu")
    monkeypatch.undo()
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("chunks_")]) == 2

    class CountingStore(ckpt.ChunkStore):
        puts = 0
        hits = 0

        def put(self, start, res):
            CountingStore.puts += 1
            super().put(start, res)

        def get(self, start):
            res = super().get(start)
            CountingStore.hits += res is not None
            return res

    monkeypatch.setattr(ckpt, "ChunkStore", CountingStore)
    resumed, hit = ckpt.cached_precompute(
        SCENE, cfg, dim, fov, cache_dir=str(tmp_path), resume=True,
        device="cpu")
    monkeypatch.undo()
    assert not hit and (CountingStore.hits, CountingStore.puts) == (2, 1)
    fresh, _ = ckpt.cached_precompute(
        SCENE, cfg, dim, fov, cache_dir=str(tmp_path / "fresh"),
        resume=True, device="cpu")
    assert resumed.final_alpha.dtype == torch.float32
    _same(resumed, fresh)
    _same(resumed, precompute_final_alpha(SCENE, cfg, dim, fov,
                                          device="cpu"))
    assert not [f for f in os.listdir(tmp_path) if f.startswith("chunks_")]


def test_resume_requires_chunking():
    with pytest.raises(ValueError, match="chunk_size"):
        ckpt.cached_precompute(SceneConfig(), RenderConfig(chunk_size=None),
                               (8, 8), (0.1, 0.1), resume=True, device="cpu")


def test_session_roundtrip_and_key_refusal(tmp_path):
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0)
    cfg = RenderConfig(dtype="float64")
    dim = (16, 20)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    pre = precompute_final_alpha(scene, cfg, dim, fov, device="cpu")
    sess = tmp_path / "session"
    key = ckpt.save_session(str(sess), scene, cfg, pre, dim, fov)
    assert key == ckpt.cache_key(scene, cfg, dim, fov)
    assert (sess / "session.json").exists() and (sess / "tables").is_dir()

    pre2, meta = ckpt.load_session(str(sess), scene, cfg, dim, fov)
    assert meta["key"] == key and meta["dim"] == list(dim)
    _same(pre2, pre)
    assert pre2.winding.dtype == torch.uint16
    assert (pre2.total_rays, pre2.traced_rays, pre2.steps) == (
        pre.total_rays, pre.traced_rays, pre.steps)
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.load_session(str(sess), SceneConfig(M=1.0, a=0.5), cfg, dim,
                          fov)
    with pytest.raises(ValueError, match="AND fov"):
        ckpt.load_session(str(sess), scene, cfg)
    pre3, _ = ckpt.load_session(str(sess))
    _same(pre3, pre)
    # Saving again replaces the session in place.
    ckpt.save_session(str(sess), scene, cfg, pre, dim, fov)
    _same(ckpt.load_session(str(sess))[0], pre)


def test_lens_cache_cli(tmp_path, monkeypatch, capsys):
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png, write_png
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(2)
    write_png("bg.png", (rng.random((16, 20, 3)) * 255).astype(np.uint8))
    base = ["lens", "--image", "bg.png", "--a", "0.9", "--fov-v", "12",
            "--device", "cpu", "--output"]
    assert main(base + ["plain.png"]) == 0
    said = []
    for name in ("miss.png", "hit.png"):
        assert main(base + [name, "--cache"]) == 0
        said.append(capsys.readouterr().out)
    assert "lookup cache MISS" in said[0] and "lookup cache HIT" in said[1]
    assert len(os.listdir("lookup_cache")) == 1
    for name in ("miss.png", "hit.png"):
        np.testing.assert_array_equal(read_png(name), read_png("plain.png"))
