"""The moving camera (a boost) of the port against the JAX package's.

The same view directions and grids go through both packages on the CPU.
Tolerances: aberrate_view and doppler_lookup in float64 to 1e-12; the
boosted alpha and theta grids in float64 to 1e-12 rad and in float32 to
4 ulp of pi (the JAX package forms its float32 view directions in float32
before the float64 aberration, the port rounds once from float64);
axis_refine_columns equal; pixel_angles_at bitwise the port's own grids
and within the grids' tolerance of JAX's. The renders: a boosted analytic
shadow equal to JAX's pixel for pixel, a boosted integrated Schwarzschild
shadow on >= 99 % of pixels, a boosted blackbody disk from float64
traces within 1e-6 of JAX's (the image is float32, as in
tests/test_torch_disk.py). The oracles of the JAX package's tests keep their own
bounds: a zero boost is the identity, the map's round trip, the forward
half-angle law tan(psi/2) = sqrt((1+b)/(1-b)) tan(psi'/2), the forward
Doppler factor sqrt((1+b)/(1-b)), an approaching camera's smaller shadow
and a bluer boosted disk.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import camera as jcam
from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu.pipeline import render_shadow as jrender_shadow
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import camera, disk
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.pipeline import render_shadow
from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                      SceneConfig)

DIM = (24, 32)
BOOST = (0.3, -0.2, 0.45)
F32_TOL = 4 * float(np.spacing(np.float32(np.pi)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fov(dim=DIM):
    return camera.fov_from_vertical(np.radians(40.0), dim)


def test_aberrate_view_and_doppler_match_jax():
    rng = np.random.default_rng(11)
    v = rng.normal(size=(3, 50))
    v /= np.linalg.norm(v, axis=0)
    wj = jcam.aberrate_view(*(jnp.asarray(c) for c in v), BOOST)
    wt = camera.aberrate_view(*(torch.tensor(c) for c in v), BOOST)
    for a, b in zip(wt, wj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    dj = jcam.doppler_lookup(DIM, _fov(), BOOST, dtype=jnp.float64)
    dt = camera.doppler_lookup(DIM, _fov(), BOOST, dtype=torch.float64,
                               device="cpu")
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        camera.aberrate_view(*(torch.tensor(c) for c in v), (0.8, 0.0, 0.7))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("psi", [(0.0, 0.0), (0.05, -0.08)])
def test_boosted_lookups_match_jax(psi, dtype):
    tol = 1e-12 if dtype == "float64" else F32_TOL
    for name in ("build_alpha_lookup", "build_theta_lookup"):
        ref = np.asarray(getattr(jcam, name)(
            DIM, _fov(), psi=psi, dtype=jnp.dtype(dtype), boost=BOOST))
        got = getattr(camera, name)(DIM, _fov(), psi=psi,
                                    dtype=getattr(torch, dtype),
                                    boost=BOOST, device="cpu")
        assert got.dtype == getattr(torch, dtype) and got.shape == DIM
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("psi", [(0.0, 0.0), (0.05, -0.08), (0.0, 0.2)])
def test_boosted_axis_refine_columns_match_jax(psi):
    ref = np.asarray(jcam.axis_refine_columns(DIM, _fov(), psi=psi,
                                              boost=BOOST))
    got = camera.axis_refine_columns(DIM, _fov(), psi=psi, boost=BOOST,
                                     device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


def test_boosted_pixel_angles_at_match_jax():
    py = np.array([0, 3, 11, 23, 7])
    px = np.array([0, 31, 16, 5, 20])
    aj, tj = jcam.pixel_angles_at(jnp.asarray(py), jnp.asarray(px), DIM,
                                  _fov(), dtype=jnp.float64, boost=BOOST,
                                  pixel_offset=(0.25, -0.5))
    at, tt = camera.pixel_angles_at(torch.tensor(py), torch.tensor(px), DIM,
                                    _fov(), dtype=torch.float64, boost=BOOST,
                                    pixel_offset=(0.25, -0.5))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-12)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-12)


def test_zero_boost_is_identity_and_roundtrip():
    grid = dict(dtype=torch.float64, device="cpu")
    for name in ("build_alpha_lookup", "build_theta_lookup"):
        fn = getattr(camera, name)
        assert torch.equal(fn(DIM, _fov(), **grid),
                           fn(DIM, _fov(), boost=(0.0, 0.0, 0.0), **grid))
    assert torch.all(camera.doppler_lookup(DIM, _fov(), (0.0, 0.0, 0.0),
                                           dtype=torch.float64,
                                           device="cpu") == 1.0)
    v = torch.tensor(np.random.default_rng(11).normal(size=(3, 50)))
    v = v / v.norm(dim=0)
    w = camera.aberrate_view(*v, BOOST)
    u = camera.aberrate_view(*w, tuple(-b for b in BOOST))
    for a, b in zip(u, v):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_forward_boost_spreads_angles_and_blueshifts():
    b = 0.6
    for psi_cam in (0.05, 0.3, 1.0, 2.0):
        v = [torch.tensor([x], dtype=torch.float64)
             for x in (np.sin(psi_cam), 0.0, np.cos(psi_cam))]
        wx, _wy, wz = camera.aberrate_view(*v, (0.0, 0.0, b))
        psi_static = float(torch.atan2(wx, wz))
        expect = 2.0 * np.arctan(np.sqrt((1.0 + b) / (1.0 - b))
                                 * np.tan(psi_cam / 2.0))
        assert psi_static > psi_cam
        assert np.isclose(psi_static, expect, atol=1e-12)
    dim = (25, 25)
    d = camera.doppler_lookup(dim, camera.fov_from_vertical(
        np.radians(10.0), dim), (0.0, 0.0, 0.5), dtype=torch.float64,
        device="cpu").numpy()
    assert np.isclose(d[12, 12], np.sqrt(1.5 / 0.5), rtol=1e-3)
    assert d.max() <= np.sqrt(1.5 / 0.5) + 1e-9 and d[0, 0] < d[12, 12]


def test_analytic_shadow_shrinks_and_matches_jax():
    cfg = RenderConfig(dtype="float64")
    n = {}
    for name, boost in (("static", (0.0, 0.0, 0.0)),
                        ("toward", (0.0, 0.0, 0.5)),
                        ("away", (0.0, 0.0, -0.5))):
        js = JScene(M=1.0, a=0.0, boost=boost)
        img, _ = render_shadow(scene_from_jax(js), (96, 96), cfg,
                               analytic=True, device="cpu")
        ref, _ = jrender_shadow(js, (96, 96), JRender(dtype="float64"),
                                analytic=True)
        np.testing.assert_array_equal(img.numpy(), np.asarray(ref))
        n[name] = int((img == 0.0).sum())
    assert 0 < n["toward"] < n["static"] < n["away"]


def test_integrated_shadow_shrinks_and_matches_jax():
    js = JScene(M=1.0, a=0.0, boost=(0.0, 0.0, 0.4))
    jcfg = JRender(dtype="float64")
    ref, _ = jrender_shadow(js, (32, 32), jcfg)
    img, _ = render_shadow(scene_from_jax(js), (32, 32),
                           render_cfg_from_jax(jcfg), device="cpu")
    assert (img.numpy() == np.asarray(ref)).mean() >= 0.99
    still, _ = render_shadow(SceneConfig(M=1.0, a=0.0), (32, 32),
                             RenderConfig(dtype="float64"), device="cpu")
    assert 0 < int((img == 0.0).sum()) < int((still == 0.0).sum())


def test_boosted_blackbody_disk_matches_jax_and_is_bluer():
    js = JScene(M=1.0, a=0.9, r_obs_mult=100.0, vertical_fov_deg=30.0,
                theta_obs=np.radians(80.0), boost=(0.0, 0.0, 0.5))
    jcfg = JRender(dtype="float64", backend="xla")
    dj = jdisk.DiskConfig(spectrum="blackbody")
    ref, _ = jdisk.render_disk(js, (12, 12), jcfg, dj)
    img, _ = disk.render_disk(scene_from_jax(js), (12, 12),
                              render_cfg_from_jax(jcfg),
                              disk.DiskConfig(spectrum="blackbody"),
                              device="cpu")
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    still, _ = disk.render_disk(
        scene_from_jax(JScene(M=1.0, a=0.9, r_obs_mult=100.0,
                              vertical_fov_deg=30.0,
                              theta_obs=np.radians(80.0))), (12, 12),
        render_cfg_from_jax(jcfg), disk.DiskConfig(spectrum="blackbody"),
        device="cpu")

    def blue(x):
        lit = x.sum(dim=-1) > 0
        return float(x[..., 2][lit].mean() / x[..., 0][lit].mean())
    assert blue(img) > blue(still)
