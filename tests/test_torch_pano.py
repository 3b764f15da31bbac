"""The port's 360-degree panoramas (pano.py, cli/pano.py) against the JAX
package.

Inputs are made from seeds with numpy and go through the JAX package on
the CPU (its one-program XLA path) and the port's plain loops:
  * the chart: pano_directions in float32 within 2e-7 of JAX (torch's and
    XLA's float32 sin and cos round apart, ROADMAP Queue 3 #6) and in
    float64 within 1e-15; build_pano_lookups (no boost, a boost, an
    offset pointing) within 1e-6 rad in float32 (the float64 products
    rounded once, as JAX's under x64; measured 7.2e-7) and 1e-12 in
    float64; pano_refine_mask equal; grid_sky bitwise; the inverse chart
    lands on every pixel centre;
  * render_panorama at 16 x 32 (Kerr a 0.9 through the Kerr tracer with
    the mirror fold, float32 and float64; Schwarzschild through the orbit
    tracer; a boost and an offset pointing without the fold; the winding
    overlay; bilinear sampling): the shadow masks equal on >= 99 % of
    pixels, final alpha of pixels escaped in both within 5e-4 rad in
    float32 (Queue 3 #6) and 1e-9 in float64, images equal on >= 99 % of
    pixels (bilinear: RMSE < 1e-3, its weights follow final alpha);
    traced rays and stage timings;
  * mesh= raises NotImplementedError;
  * `pano` end to end on the CPU: --grid-sky --height, a PNG source,
    --winding-overlay; JPEG input and --multihost raise.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import pano as jpano
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import pano
from light_path_tracer_tpu_torch.cli import main as cli_main
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.utils.save import write_png

DIM = (16, 32)
BOOST = (0.05, 0.0, 0.3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pano_directions(dtype):
    ref = jpano.pano_directions((15, 32), getattr(jnp, dtype))
    got = pano.pano_directions((15, 32), getattr(torch, dtype), "cpu")
    tol = 2e-7 if dtype == "float32" else 1e-15
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0, atol=tol)
    # the bottom rows are the exact mirror of the top ones
    vy = _np(got[1])
    assert np.array_equal(vy[:7], -vy[8:][::-1])


@pytest.mark.parametrize("case", ["plain", "boost", "offset"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pano_lookups_and_band(dtype, case):
    kw = dict(psi=(0.0, 0.0), boost=None)
    if case == "boost":
        kw["boost"] = BOOST
    if case == "offset":
        kw["psi"] = (0.1, -0.2)
    a_j, t_j = jpano.build_pano_lookups(DIM, dtype=getattr(jnp, dtype), **kw)
    a_t, t_t = pano.build_pano_lookups(DIM, dtype=getattr(torch, dtype),
                                       device="cpu", **kw)
    tol = 1e-6 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(_np(a_t), np.asarray(a_j), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(t_t), np.asarray(t_j), rtol=0, atol=tol)
    band_j = np.asarray(jpano.pano_refine_mask(a_j, t_j))
    band_t = _np(pano.pano_refine_mask(torch.tensor(np.asarray(a_j)),
                                       torch.tensor(np.asarray(t_j))))
    assert np.array_equal(band_j, band_t) and band_t.any()


def test_grid_sky_and_inverse_chart():
    assert np.array_equal(pano.grid_sky((24, 48)), jpano.grid_sky((24, 48)))
    vx, vy, vz = (v.double() for v in pano.pano_directions(
        DIM, torch.float64, "cpu"))
    px, py = pano.pano_pixel_coords(vx, vy, vz, DIM)
    cols, rows = np.meshgrid(np.arange(DIM[1]), np.arange(DIM[0]))
    assert np.array_equal(np.rint(_np(px)), cols)
    assert np.array_equal(np.rint(_np(py)), rows)


SCENES = {
    "kerr": dict(scene=dict(M=1.0, a=0.9), cfg={}),
    "kerr_f64": dict(scene=dict(M=1.0, a=0.9), cfg=dict(dtype="float64")),
    "schwarzschild": dict(scene=dict(M=1.0), cfg={}),
    "boost_offset": dict(scene=dict(M=1.0, a=0.9, psi_y=0.1,
                                    boost=(0.0, 0.0, 0.3)), cfg={}),
    "bilinear_overlay": dict(scene=dict(M=1.0, a=0.9),
                             cfg=dict(sampling="bilinear"), overlay=True),
}


@functools.lru_cache(maxsize=None)
def _render(name):
    case = SCENES[name]
    scene = JScene(r_obs_mult=30.0, **case["scene"])
    cfg = JRender(**case["cfg"])
    sky = np.random.default_rng(3).random((24, 48, 3)).astype(np.float32)
    overlay = case.get("overlay", False)
    ref = jpano.render_panorama(scene, sky, resolution=DIM, cfg=cfg,
                                winding_overlay=overlay)
    got = pano.render_panorama(scene_from_jax(scene), sky, resolution=DIM,
                               cfg=render_cfg_from_jax(cfg),
                               winding_overlay=overlay, device="cpu")
    return ref, got


@pytest.mark.parametrize("name", list(SCENES))
def test_render_panorama_matches_jax(name):
    ref, got = _render(name)
    fj, fp = np.asarray(ref.final_alpha), _np(got.final_alpha)
    assert fp.shape == DIM and fp.dtype == np.float32
    assert float((np.isnan(fj) == np.isnan(fp)).mean()) >= 0.99
    assert np.isnan(fp).any() and np.isfinite(fp).any()
    both = np.isfinite(fj) & np.isfinite(fp)
    tol = 1e-9 if name == "kerr_f64" else 5e-4
    assert np.abs(fj - fp)[both].max() < tol
    d_img = np.abs(np.asarray(ref.image) - _np(got.image))
    if name == "bilinear_overlay":
        # the weights follow final alpha continuously (measured RMSE 1.6e-5)
        assert float(np.sqrt((d_img ** 2).mean())) < 1e-3
    else:
        same = np.all(d_img < 1e-6, axis=-1)
        assert float(same.mean()) >= 0.99, float(same.mean())
    assert got.traced_rays == ref.traced_rays
    assert got.total_rays == DIM[0] * DIM[1]
    assert int(got.integrator_steps) > 0
    assert {"precompute", "render", "total"} <= set(got.timings)
    assert got.alpha_crit == pytest.approx(ref.alpha_crit, rel=1e-12)


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="mesh"):
        pano.render_panorama(scene_from_jax(JScene()), pano.grid_sky(DIM),
                             mesh=object(), device="cpu")


def test_pano_cli(tmp_path, capsys):
    out = str(tmp_path / "p.png")
    rc = cli_main(["pano", "--a", "0.9", "--r-obs", "30", "--grid-sky",
                   "--height", "12", "--device", "cpu", "--output", out])
    assert rc == 0 and os.path.exists(out)
    text = capsys.readouterr().out
    assert "Panorama 12x24: shadow covers" in text and "traced rays" in text
    src = str(tmp_path / "sky.png")
    write_png(src, (pano.grid_sky((12, 24)) * 255).astype(np.uint8))
    rc = cli_main(["pano", "--r-obs", "30", "--image", src,
                   "--winding-overlay", "--device", "cpu", "--output", out])
    assert rc == 0
    assert "Panorama 12x24" in capsys.readouterr().out
    jpg = str(tmp_path / "sky.jpg")
    with open(jpg, "wb") as fh:
        fh.write(b"\xff\xd8")
    with pytest.raises(NotImplementedError, match="JPEG"):
        cli_main(["pano", "--image", jpg, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="multihost"):
        cli_main(["pano", "--grid-sky", "--multihost", "--device", "cpu"])
