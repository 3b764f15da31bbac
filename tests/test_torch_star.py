"""The port's stellar-surface images and pulse profiles (star.py,
cli/star.py) against the JAX package.

Inputs are made from seeds with numpy and go through the JAX package on
the CPU and the port's plain loop (the surface trace's plain version):
  * StarConfig carried over by convert.star_config_from_jax; _validate's
    ValueErrors (a deformed metric, a surface inside the horizon, a
    superluminal equator, a malformed spot) as JAX's;
  * the surface-map pieces on 512 random surface points, float32 and
    float64: _physical_angles equal to JAX's (the fmod-based modulo);
    temperature4_map, surface_redshift and _emission_cos within 1e-12
    relative in float64 and 1e-5 in float32 (measured 1.9e-6: the float32
    sin and cos of the angles round apart, ROADMAP Queue 3 #6, and the
    spots' sigmoid edges steepen that ~100-fold);
  * render_star at 32^2 (a = 0.3, theta_obs 60 deg, a 2-spot map with
    rotation and limb darkening; float32 and float64; a charged scene
    through Kerr-Newman): captured pixels equal; the raw brightness
    within 1e-9 relative of its largest value in float64 (measured
    5.4e-11) and 5e-4 in float32 (measured 1.1e-4, the same rounding
    through the sigmoid edges); the tone-mapped image likewise;
    the apparent radius equal;
  * pulse_profile at 32^2 with 16 phases, with and without the retarded
    phase (light_travel_delay, the trace's time component): the phases
    equal, the flux within 1e-9 relative in float64 and 1e-4 in float32
    (measured 2.2e-5), the modulation within twice that (measured
    1.3e-5);
  * mesh= raises NotImplementedError;
  * `star` end to end on the CPU: the image, --pulse-profile N with
    --light-travel-delay (the .npz), --visibility (the .npz profile).
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import star as jstar
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import star
from light_path_tracer_tpu_torch.cli import main as cli_main
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax,
                                                 star_config_from_jax)
from light_path_tracer_tpu_torch.models import Kerr, KerrNewman

STAR = jstar.StarConfig(radius=5.0, omega=0.05, limb_k=0.5,
                        spots=((30.0, 0.0, 20.0, 1.0),
                               (120.0, 150.0, 15.0, 0.8)))
SCENE = dict(M=1.0, a=0.3, r_obs_mult=100.0, theta_obs=float(np.radians(60)),
             vertical_fov_deg=8.0)
DIM = (32, 32)
TOL = {"float32": 5e-4, "float64": 1e-9}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_star_config_and_validation():
    assert star_config_from_jax(STAR) == star.StarConfig(
        radius=5.0, omega=0.05, limb_k=0.5,
        spots=((30.0, 0.0, 20.0, 1.0), (120.0, 150.0, 15.0, 0.8)))
    assert star_config_from_jax(jstar.StarConfig()) == star.StarConfig()
    cases = [(dict(radius=1.2), "horizon"), (dict(omega=0.5), "superluminal"),
             (dict(spots=((1.0, 2.0),)), "spot")]
    for kw, match in cases:
        for mod, metric in ((jstar, JKerr(M=1.0, a=0.9)),
                            (star, Kerr(M=1.0, a=0.9))):
            with pytest.raises(ValueError, match=match):
                mod._validate(metric, mod.StarConfig(**kw))
    with pytest.raises(ValueError, match="Johannsen"):
        star.render_star(scene_from_jax(JScene(a=0.5, eps3=1.0)), (4, 4),
                         device="cpu")
    star._validate(KerrNewman(M=1.0, a=0.3, Q=0.4), star.StarConfig())


def _points(dtype, n=512):
    rng = np.random.default_rng(5)
    th = rng.uniform(-7.0, 7.0, n)
    ph = rng.uniform(-9.0, 9.0, n)
    xi = rng.uniform(-6.0, 6.0, n)
    p_r = rng.uniform(-1.0, 1.0, n)
    t_hit = rng.uniform(90.0, 120.0, n)
    return [x.astype(dtype) for x in (th, ph, xi, p_r, t_hit)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_surface_map_pieces(dtype):
    th, ph, xi, p_r, _t = _points(dtype)
    j_th, j_ph = jstar._physical_angles(jnp.asarray(th), jnp.asarray(ph))
    t_th, t_ph = star._physical_angles(torch.tensor(th), torch.tensor(ph))
    assert np.array_equal(np.asarray(j_th), _np(t_th))
    assert np.array_equal(np.asarray(j_ph), _np(t_ph))
    rel = 1e-5 if dtype == "float32" else 1e-12
    jm, tm = JKerr(M=1.0, a=0.3), Kerr(M=1.0, a=0.3)
    phase = np.asarray(0.7, dtype)
    ref = jstar.temperature4_map(STAR, j_th, j_ph, jnp.asarray(phase))
    got = star.temperature4_map(STAR, t_th, t_ph, torch.tensor(phase))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=rel)
    g_j = jstar.surface_redshift(jm, STAR, j_th, jnp.asarray(xi))
    g_t = star.surface_redshift(tm, STAR, t_th, torch.tensor(xi))
    np.testing.assert_allclose(_np(g_t), np.asarray(g_j), rtol=rel)
    c_j = jstar._emission_cos(jm, STAR, j_th, jnp.asarray(p_r), g_j)
    c_t = star._emission_cos(tm, STAR, t_th, torch.tensor(p_r), g_t)
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), rtol=rel,
                               atol=1e-30)


@functools.lru_cache(maxsize=None)
def _image(dtype, charged=False):
    scene = JScene(**dict(SCENE, Q=0.4 if charged else 0.0))
    cfg = JRender(dtype=dtype)
    ref = jstar.render_star(scene, DIM, cfg, STAR, phase=0.3)
    got = star.render_star(scene_from_jax(scene), DIM,
                           render_cfg_from_jax(cfg),
                           star_config_from_jax(STAR), phase=0.3,
                           device="cpu")
    return ref, got


@pytest.mark.parametrize("case", [("float32", False), ("float64", False),
                                  ("float32", True)])
def test_render_star_matches_jax(case):
    dtype, charged = case
    (img_j, st_j), (img_t, st_t) = _image(dtype, charged)
    assert tuple(img_t.shape) == DIM and img_t.dtype == torch.float32
    assert st_t["captured"] == st_j["captured"] > 50
    assert st_t["invalid"] == st_j["invalid"]
    assert st_t["apparent_radius_rad"] == st_j["apparent_radius_rad"]
    bj, bt = np.asarray(st_j["brightness"]), _np(st_t["brightness"])
    scale = float(bj.max())
    assert np.abs(bt - bj).max() <= TOL[dtype] * scale
    assert np.abs(_np(img_t) - np.asarray(img_j)).max() <= TOL[dtype]
    assert st_t["traced_rays"] == DIM[0] * DIM[1]
    assert st_t["integrator_steps"] > 0


@pytest.mark.parametrize("delay", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pulse_profile_matches_jax(dtype, delay):
    scene = JScene(**SCENE)
    cfg = JRender(dtype=dtype)
    ph_j, fl_j, st_j = jstar.pulse_profile(scene, cfg, STAR, n_phases=16,
                                           resolution=DIM,
                                           light_travel_delay=delay)
    ph_t, fl_t, st_t = star.pulse_profile(
        scene_from_jax(scene), render_cfg_from_jax(cfg),
        star_config_from_jax(STAR), n_phases=16, resolution=DIM,
        light_travel_delay=delay, device="cpu")
    assert np.array_equal(ph_t, np.asarray(ph_j, np.float64))
    rel = 1e-4 if dtype == "float32" else 1e-9
    np.testing.assert_allclose(fl_t, fl_j, rtol=rel)
    assert st_t["captured"] == st_j["captured"]
    assert abs(st_t["modulation"] - st_j["modulation"]) < 2 * rel
    assert st_t["modulation"] > 0.05


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="mesh"):
        star.render_star(scene_from_jax(JScene()), (4, 4), mesh=object(),
                         device="cpu")


def test_star_cli(tmp_path, capsys):
    out = str(tmp_path / "s.png")
    vis = str(tmp_path / "v.npz")
    base = ["star", "--size", "24", "--fov-v", "8", "--device", "cpu"]
    assert cli_main([*base, "--output", out, "--visibility", vis]) == 0
    text = capsys.readouterr().out
    assert "Star (5.0M): 24x24, apparent radius" in text
    assert os.path.exists(out) and os.path.exists(vis)
    assert "diameter_rad" in np.load(vis).files
    prof = str(tmp_path / "pp.npz")
    assert cli_main([*base, "--pulse-profile", "8", "--light-travel-delay",
                     "--omega", "0.05", "--spot", "60,0,20,1.0",
                     "--output", prof]) == 0
    assert "Pulse profile: 8 phases" in capsys.readouterr().out
    arr = np.load(prof)
    assert arr["phases"].shape == (8,) and arr["flux"].shape == (8,)
