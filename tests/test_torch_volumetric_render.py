"""The PyTorch port's volumetric render against the JAX package: the
Pallas volumetric tile kernel in interpret mode, and the render_volumetric
entry point.

The Pallas kernel (trace_rays_volumetric_pallas, one (1, 128) tile) and
the port's plain loop trace the same 32 float32 rays (a = 0.9, theta_obs
= 80 deg, max_steps 4000), thin and self-absorbed: status agreement >=
0.99, p99 |d emission| / max < 1e-4, p99 |d tau| < 1e-3.
render_volumetric at 24x24 (FOV 16 deg) against the JAX render: in
float64 equal captured and invalid counts, image max |d| < 1e-6 (the
image is float32), emission and tau within 1e-9 of the largest; in
float32 captured within 3 pixels, p99 |d emission| / max < 1e-4 and p99
|d image| < 1e-3. Every stats key of the JAX render is present. The
Doppler crescent of an edge-on torus, and its mirror under a retrograde
flow, on the port's CPU path.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import volumetric
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 riaf_config_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

R_OBS = 100.0
THETA = float(np.radians(80.0))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fns(riaf_kwargs):
    jr = jvol.RIAFConfig(**riaf_kwargs)
    return (jvol.make_transfer_fns(JKerr(M=1.0, a=0.9), jr),
            volumetric.make_transfer_fns(Kerr(M=1.0, a=0.9),
                                         riaf_config_from_jax(jr)))


@pytest.mark.parametrize("alpha0", [0.0, 0.5])
def test_plain_volumetric_matches_pallas_interpret(alpha0):
    """The Pallas volumetric tile kernel itself, in interpret mode (one
    (1, 128) tile), on 32 rays."""
    from light_path_tracer_tpu.ops.pallas.volumetric_kernel import (
        trace_rays_volumetric_pallas)
    (je, ja), (te, ta) = _fns(dict(alpha0=alpha0))
    ac = JKerr(M=1.0, a=0.9).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(3)
    al = rng.uniform(0.3 * ac, 4 * ac, 32).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, 32).astype(np.float32)
    rp = trace_rays_volumetric_pallas(
        JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
        je, 5000.0, 4000, absorption_fn=ja, tile_rows=1, interpret=True)
    rt = tk.trace_rays_volumetric(
        Kerr(M=1.0, a=0.9), R_OBS, torch.from_numpy(al),
        torch.from_numpy(th), THETA, te, 5000.0, 4000, absorption_fn=ta)
    sp, st = _np(rp.status), _np(rt.status)
    ok = sp == st
    assert ok.mean() >= 0.99
    ep, et = _np(rp.emission), _np(rt.emission)
    assert (ep > 0).sum() > 10
    assert np.percentile(np.abs(et - ep)[ok], 99) < 1e-4 * np.abs(ep).max()
    tp, tt = _np(rp.optical_depth), _np(rt.optical_depth)
    assert np.percentile(np.abs(tt - tp)[ok], 99) < 1e-3




@pytest.mark.parametrize("dtype,alpha0", [("float64", 0.0),
                                          ("float64", 0.3),
                                          ("float32", 0.3)])
def test_render_volumetric_matches_jax(dtype, alpha0):
    jscene = JScene(M=1.0, a=0.9, r_obs_mult=R_OBS, vertical_fov_deg=16.0,
                    theta_obs=THETA)
    jcfg = JRender(dtype=dtype, backend="xla")
    jr = jvol.RIAFConfig(alpha0=alpha0)
    dim = (24, 24)
    jimg, jst = jvol.render_volumetric(jscene, dim, jcfg, jr)
    timg, tst = volumetric.render_volumetric(
        scene_from_jax(jscene), dim, render_cfg_from_jax(jcfg),
        riaf_config_from_jax(jr), device="cpu")
    jimg = np.asarray(jimg)
    assert timg.dtype == torch.float32 and timg.shape == dim
    assert set(tst) == set(jst)
    assert set(tst["timings"]) == {"build_lookup", "precompute", "render",
                                   "total"}
    for key in ("alpha_crit", "total_rays", "traced_rays"):
        assert tst[key] == jst[key]
    assert tst["integrator_steps"] > 0
    assert tst["emission"].shape == tst["optical_depth"].shape == dim
    em_j = jst["emission"]
    if dtype == "float64":
        for key in ("captured", "invalid"):
            assert tst[key] == jst[key]
        assert np.abs(timg.numpy() - jimg).max() < 1e-6
        assert np.abs(tst["emission"] - em_j).max() < 1e-9 * em_j.max()
        assert tst["emission_total"] == pytest.approx(jst["emission_total"],
                                                      rel=1e-9)
        assert np.abs(tst["optical_depth"] - jst["optical_depth"]).max() \
            < 1e-9 * max(jst["tau_max"], 1.0)
        assert tst["tau_max"] == pytest.approx(jst["tau_max"], rel=1e-9,
                                               abs=1e-12)
    else:
        assert abs(tst["captured"] - jst["captured"]) <= 3
        d = np.abs(tst["emission"] - em_j) / em_j.max()
        assert np.percentile(d, 99) < 1e-4
        assert np.percentile(np.abs(timg.numpy() - jimg), 99) < 1e-3
    assert (tst["tau_max"] > 0) == (alpha0 > 0)


def _mirror_halves(em):
    """Left/right sums over mirror-symmetric columns (column W//2 lies on
    the axis)."""
    h = em.shape[1] // 2
    return em[:, 1:h].sum(), em[:, h + 1:].sum()


def test_doppler_crescent_and_retrograde_flip():
    """Edge-on torus at a = 0: the approaching side is beamed into a
    crescent (bright half > 2x the dim one), and a retrograde flow
    mirrors the image."""
    scene = SceneConfig(M=1.0, a=0.0, theta_obs=THETA)
    ems = []
    for prograde in (True, False):
        _img, st = volumetric.render_volumetric(
            scene, (32, 32), RenderConfig(max_steps=20000),
            volumetric.RIAFConfig(prograde=prograde), device="cpu")
        assert st["invalid"] == 0 and st["captured"] > 0
        ems.append(st["emission"])
    (l_pro, r_pro), (l_ret, r_ret) = map(_mirror_halves, ems)
    assert max(l_pro, r_pro) > 2.0 * min(l_pro, r_pro)
    assert (r_ret > l_ret) if l_pro > r_pro else (l_ret > r_ret)
    np.testing.assert_allclose(ems[1][:, 1:], ems[0][:, :0:-1], rtol=0.02,
                               atol=1e-4 * ems[0].max())
