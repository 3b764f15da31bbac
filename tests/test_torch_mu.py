"""The port's mu = cos(theta) chart and hybrid tracer against the JAX package.

Inputs are made with numpy from a seed and go through the JAX package's
XLA path on the CPU and the port's plain loop:
  * rhs5_mu, state_to_mu / state_from_mu and pole_risk, Kerr and
    Kerr-Newman, on 256 random states in float64 (rtol 1e-13; the masks
    equal);
  * trace_rays_kerr(formulation="mu") on 512 rays (a = 0.9, alpha in
    [0.3, 4] alpha_crit), DP45 and DOP853: float64 statuses equal and max
    |d final_alpha| < 1e-8 on the stable population (escaped in both,
    |alpha - alpha_crit| > 0.05 alpha_crit, off the pole-risk rays that
    the hybrid re-traces in theta); float32 statuses >= 99 % equal and
    p99 < 1e-3;
  * trace_rays_kerr_hybrid (JAX backend="xla") on a camera grid that holds
    the pole column, so that both passes run, with n_steps; the nearly
    polar observer's theta fallback; trace_batch with formulation="mu";
  * 32^2 render_shadow with formulation="mu", Kerr and Kerr-Newman,
    float64 (pixels equal on 99 %);
  * Johannsen-Psaltis with the mu chart raises, as in the JAX package.
The CUDA mu instances and the CUDA hybrid (the Pallas backend's
semantics) run on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models import KerrNewman as JKN
from light_path_tracer_tpu.ops.batch import trace_batch as jbatch
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr as jtrace
from light_path_tracer_tpu.ops.kerr_trace import (
    trace_rays_kerr_hybrid as jhybrid)
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import camera, pipeline
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman)
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.batch import trace_batch

R_OBS = 100.0
THETA = float(np.radians(80.0))
FAMILIES = {"kerr": (JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)),
            "kerr_newman": (JKN(M=1.0, a=0.6, Q=0.6),
                            KerrNewman(M=1.0, a=0.6, Q=0.6))}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rays(n, seed, ac, lo=0.3, hi=4.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo * ac, hi * ac, n), rng.uniform(-np.pi, np.pi, n),
            rng.random(n) < 0.2)


def _states(seed, n=256):
    """Random mu-states and theta-states with conserved momenta."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.5, 60.0, n)
    th = rng.uniform(0.05, np.pi - 0.05, n)
    mu = np.cos(th)
    phi = rng.uniform(-3.0, 3.0, n)
    p_r = rng.uniform(-2.0, 2.0, n)
    p_th = rng.uniform(-5.0, 5.0, n)
    p_phi = rng.uniform(-6.0, 6.0, n)
    return r, th, mu, phi, p_r, p_th, p_phi


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mu_chart_functions_match_jax(family):
    jm, tm = FAMILIES[family]
    r, th, mu, phi, p_r, p_th, p_phi = _states(1)
    # include states inside the freeze radius and on the sin^2 floor
    r[:4] = 0.5 * tm.r_plus
    mu[4:8] = (1.0, -1.0, 1.0 - 1e-17, -1.0 + 1e-17)
    p_t = -np.ones_like(r)

    def both(fn_j, fn_t, y):
        out_j = fn_j(tuple(jnp.asarray(c) for c in y))
        out_t = fn_t(tuple(torch.from_numpy(c) for c in y))
        for a, b in zip(out_j, out_t):
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-13,
                                       atol=0.0)

    both(lambda y: jm.rhs5_mu(y, jnp.asarray(p_t), jnp.asarray(p_phi)),
         lambda y: tm.rhs5_mu(y, torch.from_numpy(p_t),
                              torch.from_numpy(p_phi)),
         (r, mu, phi, p_r, p_th))
    both(jm.state_to_mu, tm.state_to_mu, (r, th, phi, p_r, p_th))
    both(jm.state_from_mu, tm.state_from_mu, (r, mu, phi, p_r, p_th))
    # the round trip is the identity away from the poles
    back = tm.state_from_mu(tm.state_to_mu(
        tuple(torch.from_numpy(c) for c in (r, th, phi, p_r, p_th))))
    np.testing.assert_allclose(back[1].numpy(), th, rtol=1e-12)
    np.testing.assert_allclose(back[4].numpy(), p_th, rtol=1e-10,
                               atol=1e-12)

    ac = jm.alpha_crit(R_OBS)
    al, sc, _ = _rays(256, 2, ac, 0.05, 4.0)
    sc[:32] = np.where(np.arange(32) % 2, 0.0, np.pi)   # the pole column
    for s_thresh in (1e-4, 1e-3):
        mj = jm.pole_risk(R_OBS, jnp.asarray(al), jnp.asarray(sc), THETA,
                          s_thresh)
        mt = tm.pole_risk(R_OBS, torch.from_numpy(al),
                          torch.from_numpy(sc), THETA, s_thresh)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        assert mt[:32].all() and not mt.all()


def _trace(jm, tm, dtype, al, th, ref, max_steps=5000, **kw):
    npdt = np.dtype(dtype)
    rj = jtrace(jm, R_OBS, jnp.asarray(al, npdt), jnp.asarray(th, npdt),
                np.pi / 2, jnp.asarray(ref), 5000.0, max_steps, **kw)
    rt = tk.trace_rays_kerr(tm, R_OBS, torch.from_numpy(al.astype(npdt)),
                            torch.from_numpy(th.astype(npdt)), np.pi / 2,
                            torch.from_numpy(ref), 5000.0, max_steps, **kw)
    assert rt.final_alpha.dtype == getattr(torch, dtype)
    return rj, rt


def _check(al, ac, rj, rt, dtype, min_stable, exclude=None):
    sj, st = _np(rj.status), _np(rt.status)
    stable = (sj == 1) & (st == 1) & (np.abs(al - ac) > 0.05 * ac)
    if exclude is not None:
        stable &= ~exclude
    assert stable.sum() > min_stable and (sj == -1).any()
    d = np.abs(_np(rj.final_alpha)[stable] - _np(rt.final_alpha)[stable])
    if dtype == "float64":
        np.testing.assert_array_equal(st, sj)
        assert d.max() < 1e-8
        np.testing.assert_array_equal(_np(rt.n_half_orbits)[stable],
                                      _np(rj.n_half_orbits)[stable])
    else:
        assert (sj == st).mean() >= 0.99
        assert np.percentile(d, 99) < 1e-3


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_mu_trace_matches_jax(dtype, method):
    jm, tm = FAMILIES["kerr"]
    ac = jm.alpha_crit(R_OBS)
    al, th, ref = _rays(512, 0, ac)
    rj, rt = _trace(jm, tm, dtype, al, th, ref, formulation="mu",
                    method=method)
    # The angles are held off the pole-risk rays (12 of the 512): the mu
    # chart alone is ill-conditioned there (p_mu ~ 1/sin(theta)), where
    # the last-ulp differences of the two packages' sin and cos at the
    # start grow to ~1e-8 rad; the hybrid re-traces exactly those rays in
    # theta (test_hybrid_matches_jax). Statuses are held on every ray.
    risk = tm.pole_risk(R_OBS, torch.from_numpy(al), torch.from_numpy(th),
                        np.pi / 2, tk.HYBRID_S_THRESH).numpy()
    assert risk.sum() < 0.05 * risk.size
    if dtype == "float32" and method == "dop853":
        # Float32 DOP853 takes chaotic steps (its E5 sum cancels to the
        # type's resolution; module docstring of test_torch_dop853.py), and
        # in the mu chart each package's float32 angles scatter ~1e-3 rad
        # (p99) about the float64 ones, so neither package's float32 run
        # reproduces the other's: 2.4e-3 apart at p99. The port's float32
        # run is held against JAX's float64 one instead, to the same 1e-3.
        rj, _ = _trace(jm, tm, "float64", al, th, ref, formulation="mu",
                       method=method)
        rj = rj._replace(status=rj.status,
                         final_alpha=_np(rj.final_alpha).astype(np.float32))
    _check(al, ac, rj, rt, dtype, 300, exclude=risk)


def test_force_invalid_freezes_lanes():
    jm, tm = FAMILIES["kerr"]
    al, th, ref = _rays(64, 3, jm.alpha_crit(R_OBS))
    fi = np.arange(64) % 3 == 0
    rj = jtrace(jm, R_OBS, jnp.asarray(al), jnp.asarray(th), np.pi / 2,
                jnp.asarray(ref), 5000.0, 5000, formulation="mu",
                force_invalid=jnp.asarray(fi))
    rt_fi = tk.trace_rays_kerr(
        tm, R_OBS, torch.from_numpy(al), torch.from_numpy(th), np.pi / 2,
        torch.from_numpy(ref), 5000.0, 5000, formulation="mu",
        force_invalid=torch.from_numpy(fi))
    assert (rt_fi.status.numpy()[fi] == tk.INVALID).all()
    np.testing.assert_array_equal(rt_fi.status.numpy(), _np(rj.status))
    assert np.isnan(rt_fi.final_alpha.numpy()[fi]).all()


def _grid(res, dtype="float64"):
    """A camera grid of config 3's frame: its centre column is the pole
    column (screen azimuth 0 or pi, L = 0)."""
    fov = camera.fov_from_vertical(np.radians(40.0), res)
    tdt = getattr(torch, dtype)
    al = camera.build_alpha_lookup(res, fov, dtype=tdt, device="cpu")
    th = camera.build_theta_lookup(res, fov, dtype=tdt, device="cpu")
    return al.reshape(-1).numpy(), th.reshape(-1).numpy()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hybrid_matches_jax(family):
    jm, tm = FAMILIES[family]
    al, th = _grid((12, 16))
    ref = np.zeros(al.shape, bool)
    n = al.size
    risk = tm.pole_risk(R_OBS, torch.from_numpy(al), torch.from_numpy(th),
                        THETA, 1e-3)
    assert 0 < int(risk.sum()) < n     # both passes run
    rj = jhybrid(jm, R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
                 jnp.asarray(ref), 5000.0, 5000, backend="xla")
    rt = tk.trace_rays_kerr_hybrid(
        tm, R_OBS, torch.from_numpy(al), torch.from_numpy(th), THETA,
        torch.from_numpy(ref), 5000.0, 5000)
    sj, st = _np(rj.status), _np(rt.status)
    np.testing.assert_array_equal(st, sj)
    esc = sj == 1
    assert esc.sum() > n // 3 and (sj == -1).any()
    assert np.abs(_np(rj.final_alpha)[esc]
                  - _np(rt.final_alpha)[esc]).max() < 1e-8
    np.testing.assert_array_equal(_np(rt.n_half_orbits)[esc],
                                  _np(rj.n_half_orbits)[esc])
    # n_steps: each pass's whole-batch loop count is a lower bound of the
    # port's per-warp sum, which has at most ceil(n / 32) warps a pass.
    warps = -(-n // 32)
    assert int(rj.n_steps) <= int(rt.n_steps) <= warps * int(rj.n_steps)
    # the pole lanes are the theta trace's: the same as a theta trace
    rth = tk.trace_rays_kerr(tm, R_OBS, torch.from_numpy(al),
                             torch.from_numpy(th), THETA,
                             torch.from_numpy(ref), 5000.0, 5000)
    r = risk.numpy()
    np.testing.assert_array_equal(st[r], rth.status.numpy()[r])
    np.testing.assert_array_equal(rt.final_alpha.numpy()[r],
                                  rth.final_alpha.numpy()[r])


def test_hybrid_polar_observer_falls_back_to_theta():
    jm, tm = FAMILIES["kerr"]
    al, th, ref = _rays(64, 5, jm.alpha_crit(R_OBS))
    polar = 0.05
    rj = jhybrid(jm, R_OBS, jnp.asarray(al), jnp.asarray(th), polar,
                 jnp.asarray(ref), 5000.0, 5000, backend="xla")
    rt = tk.trace_rays_kerr_hybrid(
        tm, R_OBS, torch.from_numpy(al), torch.from_numpy(th), polar,
        torch.from_numpy(ref), 5000.0, 5000)
    rth = tk.trace_rays_kerr(tm, R_OBS, torch.from_numpy(al),
                             torch.from_numpy(th), polar,
                             torch.from_numpy(ref), 5000.0, 5000)
    for a, b in zip(rt, rth):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(rt.status.numpy(), _np(rj.status))
    esc = _np(rj.status) == 1
    assert np.abs(_np(rj.final_alpha)[esc]
                  - rt.final_alpha.numpy()[esc]).max() < 1e-8


def test_trace_batch_mu_matches_jax():
    jm, tm = FAMILIES["kerr"]
    al, th = _grid((8, 16))
    rj = jbatch(jm, R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
                formulation="mu", max_steps=5000)
    rt = trace_batch(tm, R_OBS, torch.from_numpy(al), torch.from_numpy(th),
                     THETA, formulation="mu", max_steps=5000)
    np.testing.assert_array_equal(rt.status.numpy(), _np(rj.status))
    esc = _np(rj.status) == 1
    assert np.abs(_np(rj.final_alpha)[esc]
                  - rt.final_alpha.numpy()[esc]).max() < 1e-8
    # chunked and difficulty-sorted: the hybrid per chunk
    rc = trace_batch(tm, R_OBS, torch.from_numpy(al), torch.from_numpy(th),
                     THETA, formulation="mu", max_steps=5000,
                     chunk_size=64)
    np.testing.assert_array_equal(rc.status.numpy(), rt.status.numpy())


@pytest.mark.parametrize("family", ["kerr", "kerr_newman"])
def test_render_shadow_mu_matches_jax(family):
    a, q = (0.9, 0.0) if family == "kerr" else (0.6, 0.6)
    jscene = JScene(a=a, Q=q, theta_obs=THETA)
    jcfg = JRender(dtype="float64", formulation="mu")
    jimg, jst = jpipe.render_shadow(jscene, (32, 32), jcfg)
    cfg = render_cfg_from_jax(jcfg)
    assert cfg.formulation == "mu"
    timg, tst = pipeline.render_shadow(scene_from_jax(jscene), (32, 32),
                                       cfg, device="cpu")
    assert (timg.numpy() == np.asarray(jimg)).mean() >= 0.99
    assert tst["integrator_steps"] > 0 and jst["integrator_steps"] > 0


def test_johannsen_psaltis_mu_raises():
    tm = JohannsenPsaltis(M=1.0, a=0.9, eps3=2.0)
    al = torch.full((8,), 0.05, dtype=torch.float64)
    th = torch.linspace(0.1, 3.0, 8, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tk.trace_rays_kerr(tm, R_OBS, al, th, THETA,
                           torch.zeros(8, dtype=torch.bool), 5000.0, 10,
                           formulation="mu")
    with pytest.raises(NotImplementedError):
        trace_batch(tm, R_OBS, al, th, THETA, formulation="mu",
                    max_steps=10)
