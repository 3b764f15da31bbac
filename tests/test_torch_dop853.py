"""The port's DOP853 pair and linear event location against the JAX package.

Inputs are made with numpy from a seed and go through the JAX package's
XLA path on the CPU (whose `dp45_integrate` body the Pallas kernels share)
and the port's plain loop, both with method="dop853":
  * the Kerr shadow trace on 512 rays (a = 0.9, alpha in [0.3, 4]
    alpha_crit): float64 statuses equal and max |d final_alpha| < 1e-8 on
    the stable population (escaped in both, |alpha - alpha_crit| > 0.05
    alpha_crit); float32 statuses >= 99 % equal and p99 < 1e-3;
  * the Pallas tile kernel itself in interpret mode on two rays;
  * event_interp="linear" in float64 with both pairs (the float64 gates);
  * the disk recorder in float64 (statuses, hit counts equal; radii and
    azimuths within 1e-8 M), through disk.trace_disk_rays and, with
    linear events, through the loop itself;
  * the volumetric thin and absorbed forms, the 3-band spectrum, a
    2-frame movie and 2 orders in float64 (statuses equal; every extra
    within 1e-9 of its largest, 1e-8 for the orders as their own float64
    test allows, on all but 3 % of the rays, and within the float64 rtol,
    1e-6, of it on every ray: a ray whose accept or reject flips between
    the packages moves at the tolerance; the orders' 96 rays hold two);
  * Kerr-Newman and Johannsen-Psaltis, one case each (float64 gates);
  * a 32^2 render_shadow with integrator="dop853" (pixels equal on 99 %);
  * the JAX package's float32 no-freeze rays (tests/test_integrators.py).
In float32 the DOP853 error estimate sits at the type's resolution in the
far field (its E5 sum cancels to ~1e-7 of its terms), so XLA's own
compiled loop takes other steps than its uncompiled evaluation and the
float32 step sequences of the two packages differ; the final angles
agree to the float32 gate all the same. The CUDA instances against this
loop run on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.models import JohannsenPsaltis as JJP
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models import KerrNewman as JKN
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr as jtrace
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_spectral as jspec
from light_path_tracer_tpu.ops.kerr_trace import (
    trace_rays_volumetric as jvtrace)
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import disk, pipeline, volumetric
from light_path_tracer_tpu_torch.convert import (disk_config_from_jax,
                                                 render_cfg_from_jax,
                                                 riaf_config_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman)
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.batch import trace_batch

R_OBS = 100.0
THETA = float(np.radians(80.0))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rays(n, seed, ac, lo=0.3, hi=4.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo * ac, hi * ac, n), rng.uniform(-np.pi, np.pi, n),
            rng.random(n) < 0.2)


def _trace(jm, tm, dtype, al, th, ref, max_steps=5000, **kw):
    npdt = np.dtype(dtype)
    rj = jtrace(jm, R_OBS, jnp.asarray(al, npdt), jnp.asarray(th, npdt),
                np.pi / 2, jnp.asarray(ref), 5000.0, max_steps, **kw)
    rt = tk.trace_rays_kerr(tm, R_OBS, torch.from_numpy(al.astype(npdt)),
                            torch.from_numpy(th.astype(npdt)), np.pi / 2,
                            torch.from_numpy(ref), 5000.0, max_steps, **kw)
    assert rt.final_alpha.dtype == getattr(torch, dtype)
    return rj, rt


def _check(al, ac, rj, rt, dtype, min_stable):
    sj, st = _np(rj.status), _np(rt.status)
    stable = (sj == 1) & (st == 1) & (np.abs(al - ac) > 0.05 * ac)
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


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_dop853_matches_jax(dtype):
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    ac = jm.alpha_crit(R_OBS)
    al, th, ref = _rays(512, 0, ac)
    rj, rt = _trace(jm, tm, dtype, al, th, ref, method="dop853")
    _check(al, ac, rj, rt, dtype, 300)
    # The whole-batch JAX loop counts its global iterations: a lower
    # bound of the port's per-warp sum, which is at most 16 warps of it.
    assert int(rj.n_steps) <= int(rt.n_steps) <= 16 * int(rj.n_steps)


def test_dop853_takes_fewer_attempts_than_dp45():
    """The 8th-order pair's point: far fewer attempts a ray at the same
    tolerance (each makes 12 RHS evaluations against DP45's 6)."""
    tm = Kerr(M=1.0, a=0.9)
    al, th, ref = _rays(64, 2, tm.alpha_crit(R_OBS))
    args = (tm, R_OBS, torch.from_numpy(al), torch.from_numpy(th),
            np.pi / 2, torch.from_numpy(ref))
    y0, p_t, p_phi, _ = tm.initial_conditions_5d(R_OBS, args[2], args[3],
                                                 np.pi / 2)
    counts = {}
    for method in ("dp45", "dop853"):
        tols = tk.get_tols(torch.float64)
        _, status, _, attempts = tk.dp45_integrate(
            tm, torch.stack(y0), p_t, p_phi,
            torch.full((64,), tk.RUNNING, dtype=torch.int32),
            atol=torch.full((64,), tols["atol"], dtype=torch.float64),
            rtol=torch.full((64,), tols["rtol"], dtype=torch.float64),
            h_min=torch.tensor(tols["h_min"], dtype=torch.float64),
            tiny_err=tols["tiny_err"],
            r_capture=torch.tensor(tm.capture_radius(), dtype=torch.float64),
            r_escape=torch.tensor(2 * R_OBS, dtype=torch.float64),
            lambda_max=5000.0, h_init=1.0, max_steps=5000, method=method)
        assert (status != tk.RUNNING).all()
        counts[method] = int(attempts.sum())
    assert counts["dop853"] < 0.6 * counts["dp45"]


def test_plain_dop853_matches_pallas_interpret():
    """The Pallas tile kernel itself (interpret mode, one (8, 128) tile)
    with method="dop853", on a deep-shadow ray and an escaping ray."""
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_rays_kerr_pallas)
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    ac = jm.alpha_crit(R_OBS)
    al = np.asarray([0.2 * ac, 2.0 * ac], np.float32)
    th = np.asarray([0.3, 1.0], np.float32)
    rp = trace_rays_kerr_pallas(
        jm, R_OBS, jnp.asarray(al), jnp.asarray(th), np.pi / 2,
        jnp.zeros(2, bool), 5000.0, 5000, tile_rows=8, interpret=True,
        method="dop853")
    rt = tk.trace_rays_kerr(tm, R_OBS, torch.from_numpy(al),
                            torch.from_numpy(th), np.pi / 2,
                            torch.zeros(2, dtype=torch.bool), 5000.0, 5000,
                            method="dop853")
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rp.status))
    assert rt.status.tolist() == [-1, 1]
    assert abs(float(rt.final_alpha[1]) - float(rp.final_alpha[1])) < 1e-3
    assert np.isnan(float(rt.final_alpha[0]))


@pytest.mark.parametrize("method", ["dp45", "dop853"])
def test_linear_events_match_jax(method):
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    ac = jm.alpha_crit(R_OBS)
    al, th, ref = _rays(512, 0, ac)
    rj, rt = _trace(jm, tm, "float64", al, th, ref, method=method,
                    event_interp="linear")
    _check(al, ac, rj, rt, "float64", 300)
    # Linear location is a different answer than Hermite's, not a copy.
    rh = tk.trace_rays_kerr(tm, R_OBS, torch.from_numpy(al),
                            torch.from_numpy(th), np.pi / 2,
                            torch.from_numpy(ref), 5000.0, 5000,
                            method=method)
    esc = (rh.status == 1) & (rt.status == 1)
    assert float((rh.final_alpha - rt.final_alpha)[esc].abs().max()) > 1e-6


def test_disk_recorder_dop853_matches_jax():
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    rng = np.random.default_rng(4)
    n = 192
    al = rng.uniform(0.01, 0.12, n)
    th = rng.uniform(-np.pi, np.pi, n)
    jcfg = jdisk.DiskConfig(opaque=False, max_hits=3)
    rj = jdisk.trace_disk_rays(jm, R_OBS, jnp.asarray(al), jnp.asarray(th),
                               THETA, 5000.0, 5000, jcfg, backend="xla",
                               method="dop853", record_momentum=True)
    rt = disk.trace_disk_rays(tm, R_OBS, torch.from_numpy(al),
                              torch.from_numpy(th), THETA, 5000.0, 5000,
                              disk_config_from_jax(jcfg), method="dop853",
                              record_momentum=True)
    np.testing.assert_array_equal(_np(rt.status), _np(rj.status))
    np.testing.assert_array_equal(_np(rt.n_hits), _np(rj.n_hits))
    assert (_np(rt.n_hits) >= 1).sum() > 50 and (_np(rt.n_hits) >= 2).any()
    for key in ("r_hits", "phi_hits", "pr_hits", "pth_hits"):
        for a, b in zip(getattr(rj, key), getattr(rt, key)):
            assert np.abs(_np(a) - _np(b)).max() < 1e-8


def test_disk_branch_with_linear_events_matches_jax():
    """The loop's plane recorder with event_interp="linear" (no entry
    point asks for it; JAX's loop has it), DOP853, float64, against the
    JAX package's dp45_integrate on the same initial states."""
    from light_path_tracer_tpu.ops.kerr_trace import dp45_integrate as jint
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    rng = np.random.default_rng(6)
    n = 64
    al, th = rng.uniform(0.01, 0.12, n), rng.uniform(-np.pi, np.pi, n)
    plane = (jdisk.r_isco(1.0, 0.9), 20.0, float(np.pi / 2), False)
    tols = tk.get_tols(torch.float64)
    kw = dict(h_init=1.0, max_steps=5000, lambda_max=5000.0,
              tiny_err=tols["tiny_err"], disk_plane=plane, max_disk_hits=3,
              method="dop853", event_interp="linear")
    y0, pt, pp, _ = jm.initial_conditions_5d(R_OBS, jnp.asarray(al),
                                             jnp.asarray(th), THETA)
    ones = jnp.ones(n)
    rj = jint(jm, y0, pt, pp, jnp.full(n, 2, jnp.int32),
              atol=tols["atol"] * ones, rtol=tols["rtol"] * ones,
              h_min=jnp.asarray(tols["h_min"]),
              r_capture=jnp.asarray(jm.capture_radius()),
              r_escape=jnp.asarray(2 * R_OBS), **kw)
    y0, pt, pp, _ = tm.initial_conditions_5d(R_OBS, torch.from_numpy(al),
                                             torch.from_numpy(th), THETA)
    one = torch.ones(n, dtype=torch.float64)
    rt = tk.dp45_integrate(
        tm, torch.stack(y0), pt, pp, torch.full((n,), 2, dtype=torch.int32),
        atol=tols["atol"] * one, rtol=tols["rtol"] * one,
        h_min=torch.tensor(tols["h_min"], dtype=torch.float64),
        r_capture=torch.tensor(tm.capture_radius(), dtype=torch.float64),
        r_escape=torch.tensor(2 * R_OBS, dtype=torch.float64), **kw)
    np.testing.assert_array_equal(rt[1].numpy(), np.asarray(rj[1]))
    hj, ht = rj[4], rt[4]
    np.testing.assert_array_equal(ht["n"].numpy(), np.asarray(hj["n"]))
    assert (ht["n"] >= 1).sum() > 20
    for key in ("r", "phi"):
        for s_j, s_t in zip(hj[key], ht[key].unbind(0)):
            assert np.abs(np.asarray(s_j) - s_t.numpy()).max() < 1e-8


def _extras_pair(name):
    """(JAX trace, port trace, [(JAX extra, port extra, bar)]) of one
    extras form in float64, 96 rays of the volumetric scene's kind."""
    ac = JKerr(M=1.0, a=0.9).alpha_crit(R_OBS, THETA)
    al, th, _ = _rays(96, 1, ac)
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    jal, jth = jnp.asarray(al), jnp.asarray(th)
    tal, tth = torch.from_numpy(al), torch.from_numpy(th)
    kw = dict(method="dop853")
    if name in ("thin", "absorbed"):
        jr = jvol.RIAFConfig(alpha0=0.5 if name == "absorbed" else 0.0)
        je, ja = jvol.make_transfer_fns(jm, jr)
        te, ta = volumetric.make_transfer_fns(tm, riaf_config_from_jax(jr))
        rj = jvtrace(jm, R_OBS, jal, jth, THETA, je, 5000.0, 4000,
                     absorption_fn=ja, **kw)
        rt = tk.trace_rays_volumetric(tm, R_OBS, tal, tth, THETA, te, 5000.0,
                                      4000, absorption_fn=ta, **kw)
        return rj, rt, [(rj.emission, rt.emission, 1e-9),
                        (rj.optical_depth, rt.optical_depth, 1e-9)]
    if name == "spectral 3-band":
        jr = jvol.RIAFConfig(g_power=4.0, alpha0=1.0, opacity_index=3.0)
        freqs = (0.1, 1.0, 10.0)
        jt = jvol.make_spectral_transfer(jm, jr, freqs)
        tt = volumetric.make_spectral_transfer(tm, riaf_config_from_jax(jr),
                                               freqs)
        n_bands, monitor, bar = 3, None, 1e-9
    elif name == "movie 2-frame":
        jr = jvol.RIAFConfig(spot_amp=5.0, alpha0=0.3)
        times = (0.0, 40.0)
        jt = jvol.make_movie_transfer(jm, jr, times)
        tt = volumetric.make_movie_transfer(tm, riaf_config_from_jax(jr),
                                            times)
        n_bands, monitor, bar = 3, (2, 3), 1e-9
    else:
        jr = jvol.RIAFConfig()
        jt = jvol.make_order_transfer(jm, jr, 2)
        tt = volumetric.make_order_transfer(tm, riaf_config_from_jax(jr), 2)
        n_bands, monitor, bar = 2, (1, 2), 1e-8
    skw = dict(sat_window=512, sat_monitor=monitor, **kw)
    rj = jspec(jm, R_OBS, jal, jth, THETA, jt, n_bands, 5000.0, 4000, **skw)
    rt = tk.trace_rays_spectral(tm, R_OBS, tal, tth, THETA, tt, n_bands,
                                5000.0, 4000, **skw)
    pairs = [(rj.tau_hat, rt.tau_hat, bar)] + [
        (a, b, bar) for a, b in zip(rj.emission, rt.emission)]
    return rj, rt, pairs


@pytest.mark.parametrize("name", ["thin", "absorbed", "spectral 3-band",
                                  "movie 2-frame", "orders 2"])
def test_plain_dop853_extras_match_jax(name):
    rj, rt, pairs = _extras_pair(name)
    np.testing.assert_array_equal(_np(rt.status), _np(rj.status))
    assert (_np(pairs[0][1]) != 0).sum() > 10
    for a, b, bar in pairs:
        a, b = _np(a), _np(b)
        scale = max(np.abs(a).max(), 1.0)
        d = np.abs(a - b)
        # A step decision at err_norm ~ 1 can flip between the packages
        # (the DOP853 estimate cancels to ~1e-9 of its terms in float64):
        # that ray's integral then moves at the tolerance, rtol 1e-6.
        assert (d > bar * scale).mean() <= 0.03
        assert d.max() <= 1e-6 * scale


@pytest.mark.parametrize("family", ["kerr_newman", "johannsen_psaltis"])
def test_plain_dop853_families_match_jax(family):
    if family == "kerr_newman":
        jm, tm = JKN(M=1.0, a=0.6, Q=0.6), KerrNewman(M=1.0, a=0.6, Q=0.6)
        ac = tm.alpha_crit(R_OBS)
    else:
        jm = JJP(M=1.0, a=0.9, eps3=2.0)
        tm = JohannsenPsaltis(M=1.0, a=0.9, eps3=2.0)
        ac = 0.0668       # tests/test_torch_johannsen_psaltis.py ALPHA_CRIT
    al, th, _ = _rays(128, 3, ac, 0.2)
    ref = np.zeros(128, bool)
    rj, rt = _trace(jm, tm, "float64", al, th, ref, 20000, method="dop853")
    _check(al, ac, rj, rt, "float64", 50)


def test_render_shadow_dop853_matches_jax():
    jscene = JScene(M=1.0, a=0.9, r_obs_mult=R_OBS)
    jcfg = JRender(dtype="float32", backend="xla", integrator="dop853")
    jimg, jst = jpipe.render_shadow(jscene, (32, 32), jcfg)
    tcfg = render_cfg_from_jax(jcfg)
    assert tcfg.integrator == "dop853"
    timg, tst = pipeline.render_shadow(scene_from_jax(jscene), (32, 32),
                                       tcfg, device="cpu")
    assert (np.asarray(jimg) == timg.numpy()).mean() >= 0.99
    assert (timg.numpy() == 0.0).sum() > 5
    assert tst["integrator_steps"] > 0


def test_render_cfg_from_jax_carries_integrator_and_event_interp():
    tcfg = render_cfg_from_jax(JRender(integrator="dop853",
                                       event_interp="linear"))
    assert (tcfg.integrator, tcfg.event_interp) == ("dop853", "linear")


def test_dop853_f32_no_nan_freeze():
    """JAX's regression rays (tests/test_integrators.py): float32 DOP853
    stages can overflow to inf with y5 still finite; the non-finite error
    must reject the attempt, not freeze the lane until max_steps."""
    tm = Kerr(M=1.0, a=0.9)
    alphas = torch.tensor([0.12012033, 0.05478825, 0.05211393, 0.13118355,
                           0.24906693, 0.06807395], dtype=torch.float32)
    thetas = torch.tensor([2.7104206, -0.48213091, 0.4013553, 2.8982608,
                           -3.0726397, -2.5031316], dtype=torch.float32)
    res = trace_batch(tm, R_OBS, alphas, thetas, np.pi / 2,
                      torch.zeros(6, dtype=torch.bool), max_steps=20000,
                      integrator="dop853")
    # The whole batch is one warp: its step sum is the slowest lane's.
    assert int(res.n_steps) < 5000
    assert set(res.status.tolist()) <= {-1, 1}
