"""The port's jittered AA (aa.py) and pixel_angles_at against the JAX
package.

Inputs come from the same scenes (and a numpy-seeded texture) on both
sides; JAX runs its XLA branch on the CPU, the port its plain loops
(`device="cpu"`). Criteria:
  * aa_offsets: equal arrays;
  * pixel_angles_at: against the port's own grid builders at every pixel,
    bitwise equal in float64 and float32 (both call one helper);
  * render_shadow_aa: coverage images equal on >= 99 % of pixels
    (a flipped sample on a chaotic near-critical lane moves one pixel by
    one quantum), mirror on and off, even and odd H;
  * render_scene_aa: bilinear-sampled image RMSE < 1e-3 on the pixels
    whose samples all wind fewer than 2 half-orbits on both sides (the
    nearest-texel flip floor is 1.5-3.4e-3, ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import aa as jaa
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import aa, camera
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _texture(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("n", [1, 4, 7])
def test_aa_offsets_match_jax(n):
    np.testing.assert_array_equal(aa.aa_offsets(n), jaa.aa_offsets(n))
    assert aa.aa_offsets(n).shape == (n, 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("psi,offset", [
    ((0.0, 0.0), (0.0, 0.0)), ((0.1, -0.2), (0.375, -0.125)),
    ((0.05, 0.0), (-0.125, 0.25))])
def test_pixel_angles_at_matches_grid_builders(dtype, psi, offset):
    # One helper computes both (camera._alpha_at, _theta_at): bitwise
    # equal in either dtype.
    res = (13, 17)
    fov = camera.fov_from_vertical(np.radians(40.0), res)
    grid = dict(psi=psi, dtype=dtype, pixel_offset=offset, device="cpu")
    al_grid = camera.build_alpha_lookup(res, fov, **grid)
    th_grid = camera.build_theta_lookup(res, fov, **grid)
    py, px = torch.meshgrid(torch.arange(res[0]), torch.arange(res[1]),
                            indexing="ij")
    al, th = camera.pixel_angles_at(py.reshape(-1), px.reshape(-1), res,
                                    fov, psi=psi, dtype=dtype,
                                    pixel_offset=offset)
    assert al.dtype == th.dtype == dtype
    assert torch.equal(al.reshape(res), al_grid)
    assert torch.equal(th.reshape(res), th_grid)


def test_pixel_angles_at_rejects_boost():
    # A boost is ported: the scattered pixels' angles equal the boosted
    # grids' at those pixels bit for bit; |boost| >= 1 is a ValueError.
    res, fov, boost = (4, 5), (0.5, 0.4), (0.1, -0.2, 0.3)
    rows, cols = torch.meshgrid(torch.arange(4), torch.arange(5),
                                indexing="ij")
    al, th = camera.pixel_angles_at(rows.reshape(-1), cols.reshape(-1), res,
                                    fov, boost=boost)
    grid = dict(boost=boost, device="cpu")
    assert torch.equal(al.reshape(res),
                       camera.build_alpha_lookup(res, fov, **grid))
    assert torch.equal(th.reshape(res),
                       camera.build_theta_lookup(res, fov, **grid))
    with pytest.raises(ValueError):
        camera.pixel_angles_at(torch.zeros(2), torch.zeros(2), (4, 4),
                               (0.5, 0.5), boost=(0.8, 0.0, 0.8))


@pytest.mark.parametrize("height", [24, 25])
@pytest.mark.parametrize("mirror", [True, False])
def test_render_shadow_aa_matches_jax(height, mirror):
    res = (height, 32)
    img_j, st_j = jaa.render_shadow_aa(
        JScene(M=1.0, a=0.9), res, JRender(use_tb_symmetry=mirror),
        aa_samples=4)
    img_t, st_t = aa.render_shadow_aa(
        SceneConfig(M=1.0, a=0.9), res, RenderConfig(use_tb_symmetry=mirror),
        aa_samples=4, device="cpu")
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert img_t.shape == res and img_t.dtype == np.float32
    assert (img_t == img_j).mean() >= 0.99
    assert set(np.unique(img_t)) <= {0.0, 0.25, 0.5, 0.75, 1.0}
    assert ((img_t > 0) & (img_t < 1)).any()
    for key in ("total_rays", "traced_rays", "aa_samples"):
        assert st_t[key] == st_j[key]
    rows = height // 2 + 1
    assert st_t["traced_rays"] == (rows if mirror else height) * 32 * 4
    if mirror:
        # Mirror-filled rows are exact copies: rows r and H - r.
        np.testing.assert_array_equal(img_t[rows:],
                                      img_t[1:height - rows + 1][::-1])


def test_render_shadow_aa_schwarzschild_matches_jax():
    img_j, _ = jaa.render_shadow_aa(JScene(M=1.0), (20, 24), JRender(),
                                    aa_samples=2)
    img_t, st = aa.render_shadow_aa(SceneConfig(M=1.0), (20, 24),
                                    RenderConfig(), aa_samples=2,
                                    device="cpu")
    assert (img_t.numpy() == np.asarray(img_j)).mean() >= 0.99
    assert st["traced_rays"] == 11 * 24 * 2


def _calm(fa_nh_j, fa_nh_t):
    """Pixels whose samples all wind < 2 half-orbits on both sides."""
    return ((np.asarray(fa_nh_j).max(axis=0) < 2)
            & (fa_nh_t.numpy().max(axis=0) < 2))


@pytest.mark.parametrize("height,mirror", [(24, True), (25, True),
                                           (24, False)])
def test_render_scene_aa_matches_jax(height, mirror):
    src = _texture((height, 32, 3))
    jcfg = JRender(use_tb_symmetry=mirror, sampling="bilinear")
    tcfg = RenderConfig(use_tb_symmetry=mirror, sampling="bilinear")
    jscene, tscene = JScene(M=1.0, a=0.9), SceneConfig(M=1.0, a=0.9)
    img_j, st_j = jaa.render_scene_aa(jscene, src, jcfg, aa_samples=4)
    img_t, st_t = aa.render_scene_aa(tscene, src, tcfg, aa_samples=4,
                                     device="cpu")
    res = (height, 32)
    fov = camera.fov_from_vertical(tscene.vertical_fov, res)
    offsets = aa.aa_offsets(4)
    nh_j = jaa._trace_all_passes(jscene.metric(), jscene, jcfg, res, fov,
                                 offsets, None)[3]
    nh_t = aa._trace_all_passes(tscene.metric(), tscene, tcfg, res, fov,
                                offsets, "cpu")[1]
    calm = _calm(nh_j, nh_t)
    img_t = img_t.numpy()
    assert img_t.shape == src.shape and img_t.dtype == np.float32
    assert calm.mean() > 0.9
    rmse = float(np.sqrt(((img_t - np.asarray(img_j))[calm] ** 2).mean()))
    assert rmse < 1e-3
    assert st_t["traced_rays"] == st_j["traced_rays"]


def test_render_scene_aa_uint8_grayscale():
    src = (_texture((16, 16), 1) * 255).astype(np.uint8)
    img, st = aa.render_scene_aa(SceneConfig(M=1.0), src, RenderConfig(),
                                 aa_samples=2, device="cpu")
    assert img.shape == (16, 16) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all()) and st["aa_samples"] == 2


def test_aa_rejects_a_mesh():
    with pytest.raises(NotImplementedError, match="mesh"):
        aa.render_shadow_aa(SceneConfig(a=0.9), (8, 8), RenderConfig(),
                            mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        aa.render_scene_aa(SceneConfig(a=0.9), np.zeros((8, 8, 3)),
                           RenderConfig(), mesh=object(), device="cpu")


def test_aa_chunks_above_the_jax_threshold(monkeypatch):
    """The stacked passes go to trace_batch in pass-sized chunks above
    aa._CHUNK_ABOVE rays (lowered here), unsorted, as in the JAX package;
    the image is the one-call image."""
    calls = []
    real = aa.trace_batch

    def spy(*args, **kwargs):
        calls.append((kwargs["chunk_size"], kwargs["sort_by_difficulty"]))
        return real(*args, **kwargs)

    scene, cfg = SceneConfig(M=1.0, a=0.9), RenderConfig()
    monkeypatch.setattr(aa, "trace_batch", spy)
    # Passes of 9 x 32 rays: multiples of 32, so the plain loop's
    # vectorised body covers every lane in both batchings (a scalar tail
    # may round sin and cos otherwise).
    one, _ = aa.render_shadow_aa(scene, (16, 32), cfg, device="cpu")
    monkeypatch.setattr(aa, "_CHUNK_ABOVE", 9 * 32 * 4 - 1)
    chunked, _ = aa.render_shadow_aa(scene, (16, 32), cfg, device="cpu")
    assert calls == [(None, False), (9 * 32, False)]
    assert torch.equal(one, chunked)
