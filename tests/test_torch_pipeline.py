"""The PyTorch port's shadow main path against the JAX package's.

Both packages render the same scene, carried across by
light_path_tracer_tpu_torch.convert: a Kerr a=0.9 shadow at 32x32 with a
12-degree vertical FOV, so the shadow fills much of the frame. The JAX
side runs its XLA path on the CPU, the port its plain loop on the CPU.
Criteria: equal traced_rays; shadow masks agree on >= 99% of pixels; on
stable pixels (escaped in both, |alpha - alpha_crit| > 0.05 alpha_crit)
p99 |d final_alpha| < 1e-3 in float32 and max < 1e-8 in float64, with
equal windings.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import camera, pipeline
from light_path_tracer_tpu_torch.convert import (metric_from_jax,
                                                 render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.utils.config import RenderConfig

DIM = (32, 32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene():
    return JScene(M=1.0, a=0.9, r_obs_mult=100.0, vertical_fov_deg=12.0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_render_shadow_matches_jax(dtype):
    jscene = _scene()
    jcfg = JRender(dtype=dtype, backend="xla")
    scene, cfg = scene_from_jax(jscene), render_cfg_from_jax(jcfg)
    fov = camera.fov_from_vertical(scene.vertical_fov, DIM)

    jimg, jstats = jpipe.render_shadow(jscene, DIM, jcfg)
    timg, tstats = pipeline.render_shadow(scene, DIM, cfg, device="cpu")
    assert tstats["traced_rays"] == jstats["traced_rays"] == 16 * 32
    assert tstats["total_rays"] == jstats["total_rays"]
    assert tstats["integrator_steps"] > 0
    assert tstats["alpha_crit"] == jstats["alpha_crit"]
    assert timg.dtype == torch.float32 and timg.shape == DIM
    jmask, tmask = np.asarray(jimg) == 0.0, timg.numpy() == 0.0
    assert (jmask == tmask).mean() >= 0.99
    assert 0.05 < tmask.mean() < 0.95

    jpre = jpipe.precompute_final_alpha(jscene, jcfg, DIM, fov)
    tpre = pipeline.precompute_final_alpha(scene, cfg, DIM, fov,
                                           device="cpu")
    assert tpre.winding.dtype == torch.uint16
    fj = np.asarray(jpre.final_alpha)
    ft = tpre.final_alpha.numpy()
    alpha = camera.build_alpha_lookup(DIM, fov, dtype=torch.float64,
                                      device="cpu").numpy()
    ac = tstats["alpha_crit"]
    stable = (~np.isnan(fj) & ~np.isnan(ft)
              & (np.abs(alpha - ac) > 0.05 * ac))
    assert stable.sum() > 200
    d = np.abs(fj[stable] - ft[stable])
    if dtype == "float64":
        assert d.max() < 1e-8
    else:
        assert np.percentile(d, 99) < 1e-3
    wj = np.asarray(jpre.winding).astype(np.int64)
    wt = tpre.winding.to(torch.int32).numpy()
    np.testing.assert_array_equal(wt[stable], wj[stable])
    # The mirror fold: row k and row H-1-k are equal (k < H/2).
    np.testing.assert_array_equal(ft[:16], ft[16:][::-1])


def test_analytic_shadow_matches_jax():
    jscene = _scene()
    jimg, jstats = jpipe.render_shadow(jscene, DIM, JRender(),
                                       analytic=True)
    timg, tstats = pipeline.render_shadow(scene_from_jax(jscene), DIM,
                                          analytic=True, device="cpu")
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
    assert tstats["traced_rays"] == 0 and tstats["integrator_steps"] == 0


def test_convert_carries_state():
    jscene = JScene(M=1.0, a=0.7, r_obs_mult=80.0, psi_x=0.01,
                    vertical_fov_deg=20.0, theta_obs=1.2)
    scene = scene_from_jax(jscene)
    for f in ("M", "a", "Q", "eps3", "r_obs_mult", "psi_y", "psi_x",
              "vertical_fov_deg", "theta_obs", "boost"):
        assert getattr(scene, f) == getattr(jscene, f)
    assert scene.r_obs == jscene.r_obs
    cfg = render_cfg_from_jax(JRender(dtype="float64", precision="gate",
                                      max_steps=1234, backend="pallas"))
    assert (cfg.dtype, cfg.precision, cfg.max_steps, cfg.backend) == (
        "float64", "gate", 1234, "auto")
    assert metric_from_jax(JKerr(M=1.0, a=0.7)) == Kerr(M=1.0, a=0.7)
    assert scene.metric() == Kerr(M=1.0, a=0.7)


def test_cli_shadow_on_cpu(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    out = tmp_path / "s.png"
    rc = main(["shadow", "--a", "0.9", "--size", "16", "--fov-v", "12",
               "--device", "cpu", "--output", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Shadow (integrated): 16x16, alpha_crit=" in text
    assert "rays/s" in text and f"Saved: {out}" in text
    data = out.read_bytes()
    assert data.startswith(b"\x89PNG\r\n\x1a\n") and b"IEND" in data


@pytest.mark.parametrize("flags,line", [
    (["--aa", "4"], "Shadow (integrated, 4x AA): 16x16"),
    (["--aa", "4", "--adaptive", "--refine-frac", "0.1"],
     "adaptive AA: 25 pixels refined, 219 rays vs 1,024 uniform")])
def test_cli_shadow_aa_on_cpu(tmp_path, capsys, flags, line):
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png
    out = tmp_path / "s.png"
    rc = main(["shadow", "--a", "0.9", "--size", "16", "--fov-v", "12",
               *flags, "--device", "cpu", "--output", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert line in text and f"Saved: {out}" in text
    img = read_png(out)
    # Coverage in quarters: gray levels between black and white.
    assert img.shape == (16, 16) and ((img > 0) & (img < 1)).any()


def test_render_shadow_chunked_equals_whole_grid():
    """RenderConfig.chunk_size reaches the chunked trace_batch (sorted by
    default, and unsorted); the image and tables equal the whole-grid
    ones bitwise (160-ray chunks of the 512 traced rays: every batch a
    multiple of 32, as the plain loop's bitwise rule needs)."""
    scene = scene_from_jax(_scene())
    whole = pipeline.precompute_final_alpha(
        scene, RenderConfig(), DIM,
        camera.fov_from_vertical(scene.vertical_fov, DIM), device="cpu")
    for sort in (True, False):
        cfg = RenderConfig(chunk_size=160, sort_by_difficulty=sort)
        img, stats = pipeline.render_shadow(scene, DIM, cfg, device="cpu")
        pre = pipeline.precompute_final_alpha(
            scene, cfg, DIM, camera.fov_from_vertical(scene.vertical_fov,
                                                      DIM), device="cpu")
        assert stats["traced_rays"] == 512
        np.testing.assert_array_equal(pre.final_alpha.numpy(),
                                      whole.final_alpha.numpy())
        assert torch.equal(pre.winding.to(torch.int32),
                           whole.winding.to(torch.int32))
        assert torch.equal(img, torch.where(
            torch.isnan(whole.final_alpha), 0.0, 1.0))


def test_port_imports_without_jax():
    # jax is blocked from import: any import of it raises.
    code = ("import sys; sys.modules['jax'] = None; "
            "import light_path_tracer_tpu_torch, "
            "light_path_tracer_tpu_torch.aa, "
            "light_path_tracer_tpu_torch.adaptive, "
            "light_path_tracer_tpu_torch.cli.shadow, "
            "light_path_tracer_tpu_torch.cli, "
            "light_path_tracer_tpu_torch.cli.lens, "
            "light_path_tracer_tpu_torch.convert, "
            "light_path_tracer_tpu_torch.render, "
            "light_path_tracer_tpu_torch.utils.save, "
            "light_path_tracer_tpu_torch.models.reissner_nordstrom, "
            "light_path_tracer_tpu_torch.models.kerr_newman, "
            "light_path_tracer_tpu_torch.models.johannsen_psaltis, "
            "light_path_tracer_tpu_torch.models.numeric, "
            "light_path_tracer_tpu_torch.ops.schwarzschild_trace, "
            "light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel, "
            "light_path_tracer_tpu_torch.ops.cuda.schwarzschild_kernel, "
            "light_path_tracer_tpu_torch.disk, "
            "light_path_tracer_tpu_torch.cli.disk, "
            "light_path_tracer_tpu_torch.utils.color, "
            "light_path_tracer_tpu_torch.volumetric, "
            "light_path_tracer_tpu_torch.cli.volumetric, "
            "light_path_tracer_tpu_torch.ops.cuda.volumetric_kernel, "
            "light_path_tracer_tpu_torch.ops.cuda.bounds, "
            "light_path_tracer_tpu_torch.ops.cuda.peak_probe, "
            "light_path_tracer_tpu_torch.sequence, "
            "light_path_tracer_tpu_torch.pano, "
            "light_path_tracer_tpu_torch.star, "
            "light_path_tracer_tpu_torch.cli.animate, "
            "light_path_tracer_tpu_torch.cli.pano, "
            "light_path_tracer_tpu_torch.cli.star; "
            "bad = sorted(m for m in sys.modules if "
            "m.startswith(('jax.', 'light_path_tracer_tpu.')) or "
            "m == 'light_path_tracer_tpu'); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
