"""The crossing-time recorder (record_time: t_hits, t_end) and the
retarded-time hot-spot light curve against the JAX package.

The same rays, made with numpy from a seed, go through both packages on
the CPU. Tolerances: float64, statuses and hit counts equal, t_hits and
t_end within 1e-9 relative (a trapezoid of tdot over the same steps);
float32, hit counts agreeing on > 98 % of rays and the median relative
|d t| of rays hit in both < 1e-4. The delayed light curve at 10x10 in
float64: the same delay spread to 1e-6 M (times of ~200 M to 1e-9
relative) and flux within 1e-7 relative
(the spot's Gaussian in the phase omega (t - delay) turns the delays'
1e-12 into ~6e-9 of a sample's flux). The port
alone: t_end of an opaque stop is its crossing time, the curve repeats
after one orbit, and an empty field of view switches the delays off.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu import spectra as jspectra
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import disk, spectra
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                      SceneConfig)

R_OBS = 100.0
THETA = float(np.radians(80.0))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("opaque", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_crossing_times_match_jax(dtype, opaque):
    rng = np.random.default_rng(16)
    al, th = rng.uniform(0.01, 0.12, 48), rng.uniform(-np.pi, np.pi, 48)
    cfg = dict(opaque=opaque, max_hits=2 if opaque else 3)
    rj = jdisk.trace_disk_rays(JKerr(M=1.0, a=0.9), R_OBS,
                               jnp.asarray(al, dtype), jnp.asarray(th, dtype),
                               THETA, 5000.0, 3000, jdisk.DiskConfig(**cfg),
                               record_time=True)
    tdt = getattr(torch, dtype)
    rt = disk.trace_disk_rays(Kerr(M=1.0, a=0.9), R_OBS,
                              torch.tensor(al, dtype=tdt),
                              torch.tensor(th, dtype=tdt), THETA, 5000.0,
                              3000, disk.DiskConfig(**cfg), two_pass=False,
                              record_time=True)
    nj, nt = np.asarray(rj.n_hits), rt.n_hits.numpy()
    tj = np.stack([np.asarray(t, np.float64) for t in rj.t_hits])
    tt = np.stack([t.numpy().astype(np.float64) for t in rt.t_hits])
    if dtype == "float64":
        np.testing.assert_array_equal(nt, nj)
        np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
        np.testing.assert_allclose(tt, tj, rtol=1e-9, atol=0)
        np.testing.assert_allclose(rt.t_end.numpy(), np.asarray(rj.t_end),
                                   rtol=1e-9, atol=0)
    else:
        assert (nt == nj).mean() > 0.98
        both = (nt > 0) & (nj > 0)
        assert np.median(np.abs(tt[0] - tj[0])[both]
                         / np.abs(tj[0][both])) < 1e-4
    if opaque:
        # a parked ray's clock stops at its crossing
        hit = nt > 0
        np.testing.assert_array_equal(rt.t_end.numpy()[hit], tt[0][hit])
    assert (tt[0][nt > 0] > 0).all()


def test_delayed_light_curve_matches_jax_and_repeats():
    js = JScene(M=1.0, a=0.9, r_obs_mult=R_OBS, theta_obs=THETA)
    jcfg = JRender(dtype="float64", backend="xla")
    period = abs(2 * np.pi / disk.keplerian_omega(1.0, 0.9, 6.0))
    ts = np.linspace(0.0, 2 * period, 9)
    _t, fj, sj = jspectra.hotspot_light_curve(
        js, (10, 10), ts, jcfg, jdisk.DiskConfig(), light_travel_delay=True)
    _t, ft, st = spectra.hotspot_light_curve(
        scene_from_jax(js), (10, 10), ts, render_cfg_from_jax(jcfg),
        disk.DiskConfig(), light_travel_delay=True, device="cpu")
    np.testing.assert_allclose(ft, fj, rtol=1e-7, atol=0)
    # the spread of crossing times of ~200 M held to 1e-9 relative
    assert st["delay_spread"] == pytest.approx(sj["delay_spread"], abs=1e-6)
    assert st["delay_spread"] > 0
    np.testing.assert_allclose(ft[:4], ft[4:8], rtol=1e-9)


def test_no_disk_pixels_switches_delays_off():
    scene = SceneConfig(M=1.0, a=0.0, r_obs_mult=R_OBS, theta_obs=THETA,
                        psi_y=float(np.radians(60.0)))
    _t, f, st = spectra.hotspot_light_curve(
        scene, (8, 8), np.linspace(0.0, 50.0, 3),
        RenderConfig(dtype="float64"), disk.DiskConfig(r_out=8.0),
        light_travel_delay=True, device="cpu")
    assert st["disk_pixels"] == 0 and st["delay_spread"] == 0.0
    np.testing.assert_allclose(f, 0.0)
