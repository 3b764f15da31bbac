"""The PyTorch port's lensed render against the JAX package's.

  * The renderer on identical tables: the JAX package traces a 40x40
    Schwarzschild frame (20-degree FOV, so it holds the shadow, winding
    rays and sentinel pixels), and both renderers get the same
    (final_alpha, winding, theta) converted with numpy. Grayscale, RGB and
    RGBA sources; nearest and bilinear; loop-around on and off; psi = 0
    and psi = (0.01, -0.02). Nearest images agree exactly on >= 99.9 % of
    pixels (a texel index is a rint of float64 projections, which XLA:CPU
    forms with FMA); bilinear images agree to atol 1e-5 inside the frame
    (loop-around pixels wrapped from outside it: 2 float32 ulps of the
    texture coordinate, see the test).
  * render_scene end to end on a 32x32 checkerboard for Schwarzschild,
    Reissner-Nordstrom Q=0.6 and Kerr a=0.9 (12-degree FOV), against the
    JAX render_scene with backend="xla", in float32 and float64: equal
    traced_rays; shadow masks agree on >= 99 %; on stable pixels
    (escaped in both, |alpha - alpha_crit| > 0.05 alpha_crit)
    p99 |d final_alpha| < 1e-3 in float32 and max < 1e-8 in float64 with
    equal windings; bilinear-image RMSE < 1e-3 on pixels whose winding is
    below 2 in both (chaotic photon-ring pixels flip texels under any
    perturbation, the nearest-texel flip floor of ROADMAP.md Queue 3).
  * The stdlib PNG reader and writer, and the lens and shadow CLIs on the
    CPU.
"""

import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import camera as jcamera
from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu import render as jrender
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import camera, pipeline, render
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.utils import save

DIM = (40, 40)
FOV_DEG = 20.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def checkerboard(h, w, tiles=12):
    """examples/showcase.py's background."""
    yy, xx = np.mgrid[0:h, 0:w]
    cell = ((yy * tiles // h) + (xx * tiles // w)) % 2
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = np.where(cell, 0.92, 0.12)
    img[..., 1] = np.where(cell, 0.55, 0.35)
    img[..., 2] = np.where(cell, 0.15, 0.75)
    return img


def _source(kind):
    rng = np.random.default_rng(7)
    channels = {"gray": None, "rgb": 3, "rgba": 4}[kind]
    shape = DIM if channels is None else DIM + (channels,)
    return rng.random(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_tables(psi):
    """JAX (final_alpha, winding, theta) of a Schwarzschild frame, numpy."""
    scene = JScene(M=1.0, r_obs_mult=100.0, vertical_fov_deg=FOV_DEG,
                   psi_y=psi[0], psi_x=psi[1])
    fov = jcamera.fov_from_vertical(scene.vertical_fov, DIM)
    pre = jpipe.precompute_final_alpha(scene, JRender(backend="xla"), DIM,
                                       fov)
    theta = jcamera.build_theta_lookup(DIM, fov, psi=psi,
                                       dtype=jnp.float32)
    # Writable copies: torch.from_numpy warns on read-only arrays.
    return (np.array(pre.final_alpha), np.array(pre.winding),
            np.array(theta), fov)


def _projection(fa, theta, psi, fov):
    """The renderer's float64 texture coordinates (px, py), in numpy."""
    frame = jcamera.psi_frame(psi)
    fx, fy = jcamera.focal_lengths(DIM, fov)
    fa = np.where(np.isfinite(fa), fa, 0.0).astype(np.float32)
    s_fa, c_fa = (np.sin(fa).astype(np.float64),
                  np.cos(fa).astype(np.float64))
    s_th, c_th = (np.sin(theta).astype(np.float64),
                  np.cos(theta).astype(np.float64))
    s = [s_th * frame.e_x[i] + c_th * frame.e_y[i] for i in range(3)]
    v = [c_fa * frame.d[i] + s_fa * s[i] for i in range(3)]
    vz = np.where(v[2] > 1e-12, v[2], 1.0)
    return v[0] / vz * fx + DIM[1] / 2, v[1] / vz * fy + DIM[0] / 2


@pytest.mark.parametrize("psi", [(0.0, 0.0), (0.01, -0.02)])
@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_renderer_matches_jax_on_identical_tables(kind, sampling, loop,
                                                  psi):
    fa, wind, theta, fov = _jax_tables(psi)
    src = _source(kind)
    assert np.isnan(fa).any() and (fa > np.pi / 2).any()
    ref = np.asarray(jrender.render_lensed_image(
        src, None, fa, wind, 0.0, fov, loop, psi=psi,
        theta_lookup=jnp.asarray(theta), sampling=sampling))
    got = render.render_lensed_image(
        torch.from_numpy(src), None, torch.from_numpy(fa),
        torch.from_numpy(wind.astype(np.int32)).to(torch.uint16), 0.0, fov,
        loop, psi=psi, theta_lookup=torch.from_numpy(theta),
        sampling=sampling)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    got = got.numpy()
    if sampling == "nearest":
        same = got == ref
        same = same if same.ndim == 2 else same.all(axis=2)
        assert same.mean() >= 0.999
    else:
        # The texture coordinate is a float64 projection of float32
        # sin/cos, which the two packages take from different libraries
        # (one ulp apart at most): a coordinate p moves by up to
        # 2 ulp * |p|, and the texel values step by at most 1. That is
        # below 1e-5 inside the frame; only loop-around pixels wrapped
        # from far outside it need the larger bound.
        px, py = _projection(fa, theta, psi, fov)
        tol = np.maximum(1e-5, 2.4e-7 * np.maximum(np.abs(px), np.abs(py)))
        err = np.abs(got - ref)
        err = err if err.ndim == 2 else err.max(axis=2)
        assert (err <= tol).all(), float((err - tol).max())
    if not loop:
        # The magenta sentinel (R = 1, plus B = 1 from 3 channels on).
        magenta = np.zeros(src.shape[2:] or (1,), np.float32)
        magenta[0] = 1.0
        if magenta.size > 2:
            magenta[2] = 1.0
        px = got.reshape(-1, magenta.size)
        assert (px == magenta).all(axis=1).any()


def test_renderer_default_theta_and_winding():
    """Without theta and winding tables both renderers build their own."""
    fa, _wind, _theta, fov = _jax_tables((0.0, 0.0))
    src = _source("rgb")
    ref = np.asarray(jrender.render_lensed_image(src, None, fa, None, 0.0,
                                                 fov))
    got = render.render_lensed_image(torch.from_numpy(src), None,
                                     torch.from_numpy(fa), None, 0.0, fov)
    assert (got.numpy() == ref).all(axis=2).mean() >= 0.999
    with pytest.raises(ValueError):
        render.render_lensed_image(torch.from_numpy(src), None,
                                   torch.from_numpy(fa), None, 0.0, fov,
                                   sampling="cubic")


def _scene(family):
    kw = {"schwarzschild": {}, "rn": dict(Q=0.6), "kerr": dict(a=0.9)}
    return JScene(M=1.0, r_obs_mult=100.0, vertical_fov_deg=12.0,
                  **kw[family])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("family", ["schwarzschild", "rn", "kerr"])
def test_render_scene_matches_jax(family, dtype):
    dim = (32, 32)
    src = checkerboard(*dim)
    jscene = _scene(family)
    jcfg = JRender(dtype=dtype, backend="xla", sampling="bilinear")
    scene, cfg = scene_from_jax(jscene), render_cfg_from_jax(jcfg)

    jout = jpipe.render_scene(jscene, src, jcfg)
    tout = pipeline.render_scene(scene, src, cfg, device="cpu")
    assert tout.precompute.traced_rays == jout.precompute.traced_rays
    assert tout.precompute.total_rays == jout.precompute.total_rays == 1024
    assert tout.alpha_crit == jout.alpha_crit
    assert set(tout.timings) == {"load_image", "build_lookup", "precompute",
                                 "render", "total"}
    img = tout.image.numpy()
    assert img.dtype == np.float32 and img.shape == (32, 32, 3)
    assert np.isfinite(img).all()

    fj = np.asarray(jout.precompute.final_alpha)
    ft = tout.precompute.final_alpha.numpy()
    jmask, tmask = np.isnan(fj), np.isnan(ft)
    assert (jmask == tmask).mean() >= 0.99 and 0.05 < tmask.mean() < 0.95
    # The shadow renders black.
    assert (img[tmask] == 0.0).all()

    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    alpha = camera.build_alpha_lookup(dim, fov, dtype=torch.float64,
                                      device="cpu").numpy()
    ac = tout.alpha_crit
    stable = ~jmask & ~tmask & (np.abs(alpha - ac) > 0.05 * ac)
    assert stable.sum() > 200
    d = np.abs(fj[stable] - ft[stable])
    if dtype == "float64":
        assert d.max() < 1e-8
    else:
        assert np.percentile(d, 99) < 1e-3
    wj = np.asarray(jout.precompute.winding).astype(np.int64)
    wt = tout.precompute.winding.to(torch.int32).numpy()
    np.testing.assert_array_equal(wt[stable], wj[stable])

    calm = (wj < 2) & (wt < 2)
    diff = img[calm] - np.asarray(jout.image)[calm]
    assert np.sqrt(np.mean(diff ** 2)) < 1e-3


def test_render_scene_uint8_and_gray_sources():
    """A uint8 source becomes float32 / 255; a grayscale source renders a
    grayscale image."""
    scene = scene_from_jax(_scene("schwarzschild"))
    src8 = (checkerboard(24, 24) * 255).astype(np.uint8)
    out8 = pipeline.render_scene(scene, src8, device="cpu")
    outf = pipeline.render_scene(scene, src8.astype(np.float32) / 255.0,
                                 device="cpu")
    assert out8.image.dtype == torch.float32
    assert torch.equal(out8.image, outf.image)
    gray = pipeline.render_scene(scene, src8[..., 0].astype(np.float32)
                                 / 255.0, device="cpu")
    assert gray.image.shape == (24, 24)
    torch.testing.assert_close(gray.precompute.final_alpha,
                               out8.precompute.final_alpha, equal_nan=True)


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(11)
    shape = (9, 13) if channels is None else (9, 13, channels)
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "x.png"
    save.write_png(path, px)
    got = save.read_png(path)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, px.astype(np.float32) / 255.0)
    # matplotlib reads what this writer writes the same way.
    import matplotlib.image as mpimg
    np.testing.assert_array_equal(mpimg.imread(path), got)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_matches_matplotlib_on_filtered_files(tmp_path, mode):
    """Pillow writes adaptive scanline filters (Sub, Up, Average, Paeth);
    the stdlib reader undoes each as matplotlib does."""
    from PIL import Image
    import matplotlib.image as mpimg
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:31, 0:37]
    base = (yy * 5 + xx * 3) % 256
    bands = len(mode)
    px = np.stack([(base + 40 * c + rng.integers(0, 6, base.shape)) % 256
                   for c in range(bands)], axis=2).astype(np.uint8)
    path = tmp_path / "f.png"
    Image.fromarray(px[..., 0] if bands == 1 else px, mode).save(path)
    np.testing.assert_array_equal(save.read_png(path), mpimg.imread(path))


def test_png_reader_rejects_jpeg_and_save_png_quantizes(tmp_path):
    jpg = tmp_path / "x.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 32)
    with pytest.raises(ValueError, match="JPEG"):
        save.read_png(jpg)
    img = torch.tensor([[[0.0, 0.5, 1.0], [1.2, -0.1, 0.999]]])
    path = tmp_path / "q.png"
    save.save_png(path, img)
    got = save.read_png(path) * 255.0
    np.testing.assert_array_equal(np.rint(got).astype(np.uint8),
                                  [[[0, 127, 255], [255, 0, 254]]])


def test_cli_lens_on_cpu(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    src = tmp_path / "src.png"
    save.write_png(src, (checkerboard(20, 20) * 255).astype(np.uint8))
    out = tmp_path / "l.png"
    rc = main(["lens", "--image", str(src), "--fov-v", "12", "--device",
               "cpu", "--bilinear", "--output", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    for line in ("Metric: Schwarzschild (M=1.0, a=0.0)", "Image: 20x20",
                 "alpha_crit = 2.9486 deg", "(inside FOV)",
                 "traced rays: 400", "trace_throughput", f"Saved: {out}"):
        assert line in text
    img = save.read_png(out)
    assert img.shape == (20, 20, 3) and (img == 0.0).all(axis=2).any()


@pytest.mark.parametrize("flags,lines", [
    (["--aa", "4"], ["total rays: 1,600", "traced rays: 880"]),
    (["--aa", "4", "--adaptive", "--a", "0.9"],
     ["adaptive AA: 20 pixels refined", "rays vs 1,600 uniform",
      "traced rays: 460"])])
def test_cli_lens_aa_on_cpu(tmp_path, capsys, flags, lines):
    from light_path_tracer_tpu_torch.cli import main
    src = tmp_path / "src.png"
    save.write_png(src, (checkerboard(20, 20) * 255).astype(np.uint8))
    out = tmp_path / "l.png"
    rc = main(["lens", "--image", str(src), "--fov-v", "12", "--device",
               "cpu", *flags, "--output", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    for line in ("Image: 20x20", *lines, f"Saved: {out}"):
        assert line in text
    img = save.read_png(out)
    assert img.shape == (20, 20, 3) and (img == 0.0).all(axis=2).any()


def test_cli_shadow_schwarzschild_and_rn_on_cpu(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    out = tmp_path / "s.png"
    for extra, ac in ((["--a", "0"], "2.9486"), (["--Q", "0.6"], "2.7570")):
        assert main(["shadow", *extra, "--size", "16", "--fov-v", "12",
                     "--device", "cpu", "--output", str(out)]) == 0
        text = capsys.readouterr().out
        assert f"Shadow (integrated): 16x16, alpha_crit={ac} deg" in text
        img = save.read_png(out)
        assert img.shape == (16, 16) and 0.05 < (img == 0.0).mean() < 0.9


@pytest.mark.parametrize("flags", [
    ["--cache"], ["--multihost"], ["--progress", "bar"],
    ["--cache", "--magnification", "m.png"]])
def test_cli_lens_rejects_modes_not_ported(tmp_path, monkeypatch, flags):
    # --multihost raises; --cache (the lookup cache in ./lookup_cache) and
    # --progress are ported and run, --cache beside a map mode is ignored
    # as in JAX.
    from light_path_tracer_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    save.write_png("src.png", np.zeros((4, 4, 3), np.uint8))
    argv = ["lens", "--image", "src.png", "--device", "cpu", "--output",
            "l.png", *flags]
    if flags == ["--multihost"]:
        with pytest.raises(NotImplementedError, match="not ported"):
            main(argv)
    else:
        assert main(argv) == 0
        assert os.path.exists(flags[-1] if flags[-1].endswith(".png")
                              else "l.png")


def test_lens_parser_defaults_match_jax():
    """Every option of the JAX lens parser exists in the port's with the
    same default (the port adds --device choices of its own)."""
    from light_path_tracer_tpu.cli import build_parser as jbuild
    from light_path_tracer_tpu_torch.cli import build_parser

    def lens_defaults(parser, argv):
        return vars(parser.parse_args(["lens", *argv]))

    jd = lens_defaults(jbuild(), [])
    td = lens_defaults(build_parser(), [])
    skip = {"fn", "command", "device", "metric_py", "bilinear", "sampling"}
    for key, value in jd.items():
        if key not in skip:
            assert key in td and td[key] == value, key
    assert td["sampling"] == "nearest"
