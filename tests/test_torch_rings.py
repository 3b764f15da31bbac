"""The port's photon-ring layers (render.ring_labels,
render.ring_decomposition, pipeline.render_rings, lensed_ring_layers,
render_scene_rings and the `shadow --rings` / `lens --rings` CLI) against
the JAX package.

Scenes (made on both sides from the same numbers): Kerr a = 0.9 at
r_obs = 50 M, 30 deg vertical FOV, seen from 80 deg (every pixel traced)
and from 90 deg (the mirror fold), and Schwarzschild (the orbit
kernel's path), 32^2, so the frame holds the shadow, the direct image
and the first two lensed orders. Criteria:
  * ring_decomposition on the same tables (JAX's final_alpha and
    winding, into both packages): the masks and the composite exactly;
  * render_rings in float64: masks and per-order counts exactly; in
    float32: masks agree on >= 99 % of pixels (the order of a pixel at a
    winding fold flips on rounding) and the counts within 1 % of the
    frame;
  * lensed_ring_layers and render_scene_rings: each layer holds the
    image on its order's pixels and 0 elsewhere, the layers sum to the
    image off the shadow, and in float64 they equal JAX's to 1e-9;
  * the CLI: `shadow --rings` writes the composite and one mask a layer,
    `lens --rings` one PNG a layer, with JAX's file names and lines.
"""

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu import render as jrender
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import pipeline, render
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.utils import save

DIM = (32, 32)
SCENES = {
    "kerr80": JScene(M=1.0, a=0.9, r_obs_mult=50.0, vertical_fov_deg=30.0,
                     theta_obs=float(np.radians(80.0))),
    "kerr90": JScene(M=1.0, a=0.9, r_obs_mult=50.0, vertical_fov_deg=30.0),
    "schwarzschild": JScene(M=1.0, a=0.0, r_obs_mult=50.0,
                            vertical_fov_deg=30.0),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _both(name, dtype):
    js, jc = SCENES[name], JRender(dtype=dtype)
    return js, jc, scene_from_jax(js), render_cfg_from_jax(jc)


def test_ring_labels_match_jax():
    for k in (1, 3, 5):
        assert render.ring_labels(k) == jrender.ring_labels(k)


@pytest.mark.parametrize("max_order", [2, 3, 5])
def test_ring_decomposition_same_tables_exactly(max_order):
    js, jc, _s, _c = _both("kerr80", "float64")
    fov = (float(np.radians(30.0)), float(np.radians(30.0)))
    jpre = jpipe.precompute_final_alpha(js, jc, DIM, fov)
    fa, wind = np.asarray(jpre.final_alpha), np.asarray(jpre.winding)
    jm, jcomp = jrender.ring_decomposition(fa, wind, max_order=max_order)
    tm, tcomp = render.ring_decomposition(
        torch.tensor(fa), torch.tensor(wind.astype(np.int32)),
        max_order=max_order)
    assert tm.dtype == torch.bool and tm.shape == (max_order + 2, *DIM)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(np.asarray(jcomp), tcomp.numpy())
    # The layers tile the frame.
    assert bool((tm.sum(dim=0) == 1).all())


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_render_rings_matches_jax(name, dtype):
    js, jc, s, c = _both(name, dtype)
    jm, jcomp, jst = jpipe.render_rings(js, DIM, jc)
    tm, tcomp, tst = pipeline.render_rings(s, DIM, c, device="cpu")
    assert set(tst) == set(jst)
    assert tst["traced_rays"] == jst["traced_rays"]
    assert tst["total_rays"] == jst["total_rays"]
    assert tst["integrator_steps"] > 0
    assert tst["alpha_crit"] == pytest.approx(jst["alpha_crit"], rel=1e-12)
    jm = np.asarray(jm)
    counts = tst["order_pixels"]
    assert list(counts) == list(jst["order_pixels"])
    assert counts["order_0"] > 0 and counts["order_1"] > 0
    assert counts["shadow"] > 0
    if dtype == "float64":
        assert np.array_equal(jm, tm.numpy())
        assert counts == jst["order_pixels"]
        assert np.array_equal(np.asarray(jcomp), tcomp.numpy())
    else:
        assert (jm == tm.numpy()).all(axis=0).mean() >= 0.99
        for lab, n in counts.items():
            assert abs(n - jst["order_pixels"][lab]) <= 0.01 * DIM[0] * DIM[1]


def _source():
    return np.random.default_rng(7).random((*DIM, 3)).astype(np.float32)


def test_lensed_ring_layers_and_scene_rings_match_jax():
    js, jc, s, c = _both("kerr80", "float64")
    src = _source()
    jl, jimg, jst = jpipe.render_scene_rings(js, src, jc)
    tl, timg, tst = pipeline.render_scene_rings(s, src, c, device="cpu")
    assert list(tst["order_pixels"]) == list(jst["order_pixels"])
    assert tst["order_pixels"] == jst["order_pixels"]
    assert tl.shape == (5, *DIM, 3)
    assert np.allclose(np.asarray(jl), tl.numpy(), rtol=0, atol=1e-9)
    off_shadow = ~torch.isnan(
        pipeline.precompute_final_alpha(
            s, c, DIM, (float(np.radians(30.0)),) * 2,
            device="cpu").final_alpha)
    assert torch.equal(tl[:-1].sum(dim=0)[off_shadow], timg[off_shadow])

    # lensed_ring_layers on one render's own tables, gray image too.
    out = pipeline.render_scene(s, src[..., 0], c, device="cpu")
    layers, counts = pipeline.lensed_ring_layers(
        out.precompute.final_alpha, out.precompute.winding, out.image,
        max_order=2)
    jlayers, jcounts = jpipe.lensed_ring_layers(
        np.asarray(out.precompute.final_alpha),
        np.asarray(out.precompute.winding), out.image.numpy(), max_order=2)
    assert counts == jcounts
    assert np.array_equal(np.asarray(jlayers), layers.numpy())


def test_cli_shadow_rings(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    out = tmp_path / "r.png"
    assert main(["shadow", "--rings", "--a", "0.9", "--size", "24",
                 "--fov-v", "30", "--r-obs", "50", "--max-order", "2",
                 "--device", "cpu", "--output", str(out)]) == 0
    text = capsys.readouterr().out
    assert "Photon-ring decomposition: 24x24, a=0.9, precompute" in text
    assert f"Saved: {out} (+ 4 per-order masks)" in text
    assert "order_0" in text and "shadow" in text
    assert save.read_png(out).shape == (24, 24, 3)
    for label in ("order0", "order1", "order2plus", "shadow"):
        mask = save.read_png(tmp_path / f"r_{label}.png")
        assert mask.shape == (24, 24) and set(np.unique(mask)) <= {0.0, 1.0}


def test_cli_lens_rings(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    src = tmp_path / "src.png"
    save.write_png(src, (_source() * 255).astype(np.uint8))
    out = tmp_path / "l.png"
    assert main(["lens", "--rings", "--image", str(src), "--a", "0.9",
                 "--fov-v", "30", "--r-obs", "50", "--device", "cpu",
                 "--output", str(out)]) == 0
    text = capsys.readouterr().out
    assert "order_ge_3" in text and f"Saved: {out}" in text
    for label in ("order0", "order1", "order2", "orderge3", "shadow"):
        assert save.read_png(tmp_path / f"l_{label}.png").shape == (*DIM, 3)
