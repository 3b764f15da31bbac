"""The port's point-image solver (images.py: _triangle_candidates,
_dedup, find_point_images, format_image_table and `lens --find-images`)
against the JAX package.

Scene: tests/test_images.py's weak-field point lens (Schwarzschild,
r_obs = 1000 M, 40 deg vertical FOV, float64 'precise'), its coarse grid
cut from 256^2 to 48^2, with the source at one Einstein angle
theta_E = sqrt(4 M / r_obs) on the x axis, and at 0.6 rad (outside the
field: no images). Both packages run on the CPU. Criteria:
  * the candidate search on the same lens map: the seeds and the
    deduplicated points exactly;
  * find_point_images: the same number of candidates and images, each
    image's refined pixel within 1e-9 px, its magnification and delay
    within 1e-9 relative (the delay's floor 1e-9 M), its winding and
    parity equal, its float32 camera angles within 2 ulps; the stats keys
    JAX's are; the table text identical;
  * the weak-field oracle of tests/test_images.py with its bars: two
    images on opposite sides, the primary first (tau = 0, even, winding
    0), the counter-image odd and winding 1; positions within 3 % and
    8 % of theta+-, magnifications and the Refsdal delay within 5 %.
"""

import functools

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import images as jimages
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import images
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)

WEAK = JScene(M=1.0, a=0.0, r_obs_mult=1000.0, vertical_fov_deg=40.0)
CFG64 = JRender(dtype="float64", precision="precise")
THETA_E = float(np.sqrt(4.0 / 1000.0))
DIM = (48, 48)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _solve(package, beta):
    if package == "jax":
        return jimages.find_point_images(WEAK, beta, resolution=DIM,
                                         cfg=CFG64)
    return images.find_point_images(scene_from_jax(WEAK), beta,
                                    resolution=DIM,
                                    cfg=render_cfg_from_jax(CFG64),
                                    device="cpu")


def test_candidates_and_dedup_same_inputs():
    rng = np.random.default_rng(3)
    bx = rng.normal(size=(12, 10)).cumsum(axis=1) * 0.1
    by = rng.normal(size=(12, 10)).cumsum(axis=0) * 0.1
    bx[3, 4] = np.nan
    for beta in ((0.05, 0.1), (0.3, -0.2), (5.0, 5.0)):
        js = jimages._triangle_candidates(bx, by, beta)
        ts = images._triangle_candidates(bx, by, beta)
        assert np.array_equal(js, ts)
        for radius in (0.5, 0.75, 3.0):
            assert np.array_equal(jimages._dedup(js, radius),
                                  images._dedup(ts, radius))


def test_find_point_images_matches_jax():
    jimgs, jst = _solve("jax", (THETA_E, 0.0))
    timgs, tst = _solve("port", (THETA_E, 0.0))
    assert set(tst) == set(jst)
    for key in ("n_candidates", "n_images", "total_rays", "traced_rays"):
        assert tst[key] == jst[key], key
    assert tst["integrator_steps"] > 0
    assert tst["total_abs_mu"] == pytest.approx(jst["total_abs_mu"],
                                                rel=1e-9)
    assert len(timgs) == len(jimgs) == 2
    for j, t in zip(jimgs, timgs):
        assert abs(t.py - j.py) < 1e-9 and abs(t.px - j.px) < 1e-9
        assert t.mu == pytest.approx(j.mu, rel=1e-9)
        assert t.tau == pytest.approx(j.tau, rel=1e-9, abs=1e-9)
        assert t.winding == j.winding and t.parity == j.parity
        assert t.converged and j.converged
        # float32 camera angles: JAX rounds each operation to float32,
        # the port the float64 result once.
        assert t.alpha_rad == pytest.approx(j.alpha_rad, rel=2.0 ** -21)
        assert t.screen_theta_rad == pytest.approx(j.screen_theta_rad,
                                                   rel=2.0 ** -21)
        assert t.beta_residual < 0.05 * np.radians(40.0) / DIM[0]
    assert (images.format_image_table(timgs, tst)
            == jimages.format_image_table(jimgs, jst))


def test_point_lens_oracle():
    """tests/test_images.py's weak-field bars on the port's solution."""
    imgs, stats = _solve("port", (THETA_E, 0.0))
    primary, secondary = imgs
    s = np.sqrt(5.0)
    assert primary.alpha_rad == pytest.approx((s + 1) / 2 * THETA_E,
                                              rel=0.03)
    assert secondary.alpha_rad == pytest.approx((s - 1) / 2 * THETA_E,
                                                rel=0.08)
    assert abs(primary.screen_theta_rad - secondary.screen_theta_rad) == \
        pytest.approx(np.pi, abs=0.02)
    mu = 3.0 / (2.0 * s)
    assert primary.mu == pytest.approx(mu + 0.5, rel=0.05)
    assert secondary.mu == pytest.approx(-(mu - 0.5), rel=0.05)
    assert stats["total_abs_mu"] == pytest.approx(3.0 / s, rel=0.05)
    dt = 4.0 * (s / 2.0 + np.log((s + 1.0) / (s - 1.0)))
    assert primary.tau == 0.0
    assert secondary.tau == pytest.approx(dt, rel=0.05)
    assert (primary.winding, secondary.winding) == (0, 1)
    assert (primary.parity, secondary.parity) == (1, -1)


def test_no_images_outside_the_field():
    jimgs, jst = _solve("jax", (0.6, 0.0))
    timgs, tst = _solve("port", (0.6, 0.0))
    assert timgs == jimgs == []
    assert set(tst) == set(jst) and tst["n_images"] == 0


def test_cli_find_images(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    bx = float(np.degrees(THETA_E))
    assert main(["lens", "--find-images", f"{bx},0", "--size", "32",
                 "--r-obs", "1000", "--dtype", "float64", "--device",
                 "cpu"]) == 0
    text = capsys.readouterr().out
    assert f"Images of point source at beta = ({bx:.4f}, 0.0000) deg " \
           f"(32x32 grid):" in text
    assert "2 candidates -> 2 images" in text and "refine" in text
    assert main(["lens", "--find-images", "nonsense", "--size", "8",
                 "--device", "cpu"]) == 2
    assert "--find-images expects BX,BY in degrees" in \
        capsys.readouterr().out
