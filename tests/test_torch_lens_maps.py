"""The port's lens-map modes (pipeline.render_magnification,
render_caustics, render_microlens_curve, render_time_delay,
render_shear) against the JAX package; the functions beneath them and
the CLI are held in tests/test_torch_lens_map_functions.py.

Scene (both sides from the same numbers): Kerr a = 0.9 at r_obs = 50 M,
30 deg vertical FOV, seen from 80 deg, 32^2, so every map holds the
shadow, both images and the critical curves. Both packages run on the
CPU. Criteria:
  * each render_* mode, float64: the stats keys JAX's are; float64 maps
    (tau, beta_x, beta_y) within 1e-9 relative per pixel (floored at
    1e-3 of the map's largest value: beta_y crosses 0 on the middle row,
    where a rounding-level difference of 1e-14 is large relative to the
    value) on pixels finite in both, eleven winding-1 pixels of beta_y
    named and xfailed with each side's numbers (TAU_LANES), the
    finite masks equal; the maps both packages emit as float32
    (magnification, caustics, the microlens curve, the shear maps)
    within 2 float32 ulps per pixel or 1e-9 of the largest value;
  * float32: p99 |port - JAX float32| < 1e-3 of the largest value of
    JAX's float64 map, and the port's own float32 error (p99 |port - JAX
    float64|) at most 1.25 x JAX's plus 1e-4 of that value.
    Magnification and shear on the pixels whose 3x3 neighbourhood is
    finite in all three maps (~630-690 of 1,024), the others on the
    pixels finite in all three. JAX's own float32 error exceeds 1e-3 of
    the largest value on some of these maps (this scene: caustics p99
    9.5e-3, the microlens curve 7.1e-3, the shear maps' kappa 1.4e-3 and
    omega 4.9e-3), so the port is held to it rather than to 1e-3.
"""

import functools

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import camera as jcamera
from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import pipeline
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)

DIM = (32, 32)
JS = JScene(M=1.0, a=0.9, r_obs_mult=50.0, vertical_fov_deg=30.0,
            theta_obs=float(np.radians(80.0)))
FOV = jcamera.fov_from_vertical(JS.vertical_fov, DIM)
F32_MAPS = ("mu", "A", "curve", "kappa", "gamma1", "gamma2", "omega",
            "gamma")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return np.asarray(torch.as_tensor(x).cpu()) if isinstance(
        x, torch.Tensor) else np.asarray(x)


def _calm(*maps):
    """Pixels whose 3x3 neighbourhood is finite in every map."""
    ok = np.ones(maps[0].shape, bool)
    for m in maps:
        p = np.pad(np.isfinite(m), 1, constant_values=False)
        for dy in range(3):
            for dx in range(3):
                ok &= p[dy:dy + m.shape[0], dx:dx + m.shape[1]]
    return ok


def _mode(package, mode, dtype):
    jc = JRender(dtype=dtype)
    if package == "jax":
        s, c, mod, kw = JS, jc, jpipe, {}
    else:
        s, c, mod = scene_from_jax(JS), render_cfg_from_jax(jc), pipeline
        kw = dict(device="cpu")
    if mode == "magnification":
        mu, st = mod.render_magnification(s, DIM, c, **kw)
        return {"mu": _np(mu)}, st
    if mode == "caustics":
        a, ext, st = mod.render_caustics(s, DIM, c, bins=24, **kw)
        st = dict(st, extent=tuple(ext))
        return {"A": _np(a)}, st
    if mode == "microlens":
        u, curve, st = mod.render_microlens_curve(s, DIM, c, n_points=11,
                                                  **kw)
        return {"curve": _np(curve), "u": _np(u)}, st
    if mode == "time_delay":
        tau, st = mod.render_time_delay(s, DIM, c, **kw)
        return {"tau": _np(tau), "beta_x": st.pop("beta_x"),
                "beta_y": st.pop("beta_y")}, st
    maps, st = mod.render_shear(s, DIM, c, **kw)
    return {k: _np(v) for k, v in maps.items()}, st


_mode_cached = functools.lru_cache(maxsize=None)(_mode)

MODES = ("magnification", "caustics", "microlens", "time_delay", "shear")

# Pixels of the float64 arrival-time map's beta_y that JAX and the port
# end apart by more than the bar: winding-1 rays on the middle row, whose
# float64 raw states differ in the last bits by how sin and cos round
# (ROADMAP Queue 3 #6) and grow by the orbit; beta_y, near 0 there, shows
# it. (row, column): JAX's value, the port's.
TAU_LANES = {
    (16, 0): (0.001206900268178415, 0.0012069005507848822),
    (16, 1): (0.0019005136229947167, 0.0019005134656676348),
    (16, 4): (0.008128517707040685, 0.008128517621777503),
    (16, 5): (0.015096431962891762, 0.015096433933637698),
    (16, 6): (0.03447153803541859, 0.03447154292840899),
    (16, 23): (-0.03812902087369255, -0.03812901822085416),
    (16, 24): (-0.01761624936024462, -0.017616248854315824),
    (16, 26): (-0.005744182872444721, -0.005744181360909083),
    (16, 27): (-0.0035964732526989128, -0.003596472501095703),
    (16, 28): (-0.0023118641947389475, -0.0023118642301398484),
    (16, 31): (-0.0005920437136762937, -0.000592043773529504)}


def _f64_bar(name, j, t, skip=()):
    """The float64 mode's per-pixel bar on the map `name`; pixels in
    `skip` (row, column) are left out. Returns the failing pixels."""
    ok = np.isfinite(j)
    for idx in skip:
        ok[idx] = False
    j64, t64 = j.astype(np.float64), t.astype(np.float64)
    scale = float(np.abs(j64[np.isfinite(j)]).max())
    if name in F32_MAPS:
        bound = np.maximum(2.0 ** -22 * np.abs(j64), 1e-9 * scale)
    else:
        bound = 1e-9 * np.maximum(np.abs(j64), 1e-3 * scale)
    bad = ok & ~(np.abs(j64 - t64) <= bound)
    return list(zip(*np.nonzero(bad)))


@pytest.mark.parametrize("mode", MODES)
def test_render_mode_float64_matches_jax(mode):
    jmaps, jst = _mode_cached("jax", mode, "float64")
    tmaps, tst = _mode_cached("port", mode, "float64")
    assert set(tst) == set(jst) - ({"beta_x", "beta_y"}
                                   if mode == "time_delay" else set())
    for key in ("total_rays", "traced_rays", "shadow_pixels",
                "negative_parity_pixels", "theta_E", "beta_max", "extent"):
        if key in jst:
            assert tst[key] == jst[key], key
    assert tst["integrator_steps"] > 0
    for key in ("mu_abs_max", "A_max", "A_far_field", "A_peak",
                "A_baseline", "tau_max", "gamma_max", "omega_abs_max"):
        if key in jst:
            assert tst[key] == pytest.approx(jst[key], rel=1e-6), key
    for name, j in jmaps.items():
        t = tmaps[name]
        assert t.shape == j.shape and t.dtype == j.dtype, name
        assert np.array_equal(np.isfinite(j), np.isfinite(t)), name
        skip = tuple(TAU_LANES) if name == "beta_y" else ()
        assert _f64_bar(name, j, t, skip) == [], name


@pytest.mark.parametrize("lane", [
    pytest.param(lane, marks=pytest.mark.xfail(
        reason=f"beta_y at {lane}: JAX {jv!r}, the port {tv!r} (winding 1; "
               f"ROADMAP Queue 3 #6: float64 sin/cos round apart)"))
    for lane, (jv, tv) in TAU_LANES.items()])
def test_time_delay_float64_winding_lanes(lane):
    jmaps, _ = _mode_cached("jax", "time_delay", "float64")
    tmaps, _ = _mode_cached("port", "time_delay", "float64")
    assert float(jmaps["beta_y"][lane]) == TAU_LANES[lane][0]
    assert lane not in _f64_bar("beta_y", jmaps["beta_y"], tmaps["beta_y"])


@pytest.mark.parametrize("mode", MODES)
def test_render_mode_float32_matches_jax(mode):
    j64, _ = _mode_cached("jax", mode, "float64")
    j32, jst = _mode_cached("jax", mode, "float32")
    t32, tst = _mode("port", mode, "float32")
    assert set(tst) == set(jst)
    for name, ref in j64.items():
        if name in ("u", "beta_x", "beta_y"):
            continue
        a, b = j32[name], t32[name]
        if mode in ("magnification", "shear"):
            sel = _calm(ref, a, b)
        else:
            sel = np.isfinite(ref) & np.isfinite(a) & np.isfinite(b)
        assert sel.sum() >= 0.5 * sel.size, name
        scale = float(np.abs(ref[sel]).max())
        gap = np.percentile(np.abs(b - a)[sel], 99) / scale
        e_j = np.percentile(np.abs(a - ref)[sel], 99) / scale
        e_t = np.percentile(np.abs(b - ref)[sel], 99) / scale
        assert gap < 1e-3, (name, gap)
        assert e_t <= 1.25 * e_j + 1e-4, (name, e_t, e_j)
