"""The port's charged (Kerr-Newman) volumetric transfer against the JAX
package.

Inputs are made with numpy from a seed and go through the JAX package's
XLA path on the CPU and the port's plain loop, a = 0.6 and Q = 0.6 in
float64: the flow reads the charge through W = 2Mr - Q^2, Q^2 in Delta
and the charged Keplerian Omega, the geodesic through Kerr-Newman's RHS.
  * the thin, absorbed, jet (beta 0.6), 3-band spectral, 2-frame movie and
    2-order forms on 96 rays (alpha in [0.3, 4] alpha_crit, theta_obs 80
    deg): statuses equal; every extra within 1e-9 of its largest value
    on all but 3 % of the rays and within rtol 1e-6 of it on every ray (a
    step decision at err_norm ~ 1 can flip between the packages, and
    that ray's integral then moves at the tolerance);
  * a 16^2 render_volumetric of a charged scene (scene_from_jax and
    riaf_config_from_jax carrying it) against JAX's;
  * the movie's spot period carries the charge;
  * the polarized form with a charge raises JAX's ValueError.
The CUDA Kerr-Newman instances run on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import polarization as jpol
from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.models import KerrNewman as JKN
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_spectral as jspec
from light_path_tracer_tpu.ops.kerr_trace import (
    trace_rays_volumetric as jvtrace)
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import polarization, volumetric
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 riaf_config_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import KerrNewman
from light_path_tracer_tpu_torch.ops import kerr_trace as tk

R_OBS = 100.0
THETA = float(np.radians(80.0))
A, Q = 0.6, 0.6
FORMS = ["thin", "absorbed", "jet", "spectral 3-band", "movie 2-frame",
         "orders 2"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(name):
    jm, tm = JKN(M=1.0, a=A, Q=Q), KerrNewman(M=1.0, a=A, Q=Q)
    ac = tm.alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(8)
    n = 96
    al, th = rng.uniform(0.3 * ac, 4.0 * ac, n), rng.uniform(-np.pi, np.pi, n)
    jal, jth = jnp.asarray(al), jnp.asarray(th)
    tal, tth = torch.from_numpy(al), torch.from_numpy(th)
    if name in ("thin", "absorbed", "jet"):
        jr = jvol.RIAFConfig(**{"thin": {}, "absorbed": dict(alpha0=0.5),
                                "jet": dict(profile="jet", jet_beta=0.6,
                                            index=-1.0)}[name])
        je, ja = jvol.make_transfer_fns(jm, jr)
        te, ta = volumetric.make_transfer_fns(tm, riaf_config_from_jax(jr))
        rj = jvtrace(jm, R_OBS, jal, jth, THETA, je, 5000.0, 4000,
                     absorption_fn=ja)
        rt = tk.trace_rays_volumetric(tm, R_OBS, tal, tth, THETA, te, 5000.0,
                                      4000, absorption_fn=ta)
        return rj, rt, [(rj.emission, rt.emission),
                        (rj.optical_depth, rt.optical_depth)]
    if name == "spectral 3-band":
        jr = jvol.RIAFConfig(g_power=4.0, alpha0=1.0, opacity_index=3.0)
        freqs = (0.1, 1.0, 10.0)
        jt = jvol.make_spectral_transfer(jm, jr, freqs)
        tt = volumetric.make_spectral_transfer(tm, riaf_config_from_jax(jr),
                                               freqs)
        n_bands, monitor = 3, None
    elif name == "movie 2-frame":
        jr = jvol.RIAFConfig(spot_amp=5.0, alpha0=0.3)
        times = (0.0, 40.0)
        jt = jvol.make_movie_transfer(jm, jr, times)
        tt = volumetric.make_movie_transfer(tm, riaf_config_from_jax(jr),
                                            times)
        n_bands, monitor = 3, (2, 3)
    else:
        jr = jvol.RIAFConfig()
        jt = jvol.make_order_transfer(jm, jr, 2)
        tt = volumetric.make_order_transfer(tm, riaf_config_from_jax(jr), 2)
        n_bands, monitor = 2, (1, 2)
    kw = dict(sat_window=512, sat_monitor=monitor)
    rj = jspec(jm, R_OBS, jal, jth, THETA, jt, n_bands, 5000.0, 4000, **kw)
    rt = tk.trace_rays_spectral(tm, R_OBS, tal, tth, THETA, tt, n_bands,
                                5000.0, 4000, **kw)
    return rj, rt, [(rj.tau_hat, rt.tau_hat)] + list(
        zip(rj.emission, rt.emission))


@pytest.mark.parametrize("name", FORMS)
def test_charged_extras_match_jax(name):
    rj, rt, pairs = _pair(name)
    np.testing.assert_array_equal(_np(rt.status), _np(rj.status))
    assert (_np(pairs[0][1]) != 0).sum() > 10
    for a, b in pairs:
        a, b = _np(a), _np(b)
        scale = max(np.abs(a).max(), 1e-300)
        d = np.abs(a - b)
        assert (d > 1e-9 * scale).mean() <= 0.03
        assert d.max() <= 1e-6 * scale


def test_charged_flow_differs_from_kerr():
    """The charge reaches the flow: the same rays through Kerr's flow at
    the same spin give another thin image."""
    from light_path_tracer_tpu_torch.models import Kerr
    riaf = volumetric.RIAFConfig()
    al = torch.linspace(0.02, 0.2, 32, dtype=torch.float64)
    th = torch.linspace(-3.0, 3.0, 32, dtype=torch.float64)
    out = []
    for m in (KerrNewman(M=1.0, a=A, Q=Q), Kerr(M=1.0, a=A)):
        e, _ = volumetric.make_transfer_fns(m, riaf)
        out.append(tk.trace_rays_volumetric(m, R_OBS, al, th, THETA, e,
                                            5000.0, 4000).emission)
    assert float((out[0] - out[1]).abs().max()) > 1e-3 * float(
        out[1].abs().max())


def test_render_volumetric_charged_matches_jax():
    jscene = JScene(M=1.0, a=A, Q=Q, theta_obs=THETA, vertical_fov_deg=16.0)
    jcfg = JRender(dtype="float64")
    jr = jvol.RIAFConfig(alpha0=0.3)
    jimg, jst = jvol.render_volumetric(jscene, (16, 16), jcfg, jr)
    scene = scene_from_jax(jscene)
    assert scene.Q == Q and scene.a == A
    riaf = riaf_config_from_jax(jr)
    assert riaf == volumetric.RIAFConfig(alpha0=0.3)
    timg, tst = volumetric.render_volumetric(
        scene, (16, 16), render_cfg_from_jax(jcfg), riaf, device="cpu")
    ej, et = np.asarray(jst["emission"]), tst["emission"]
    assert (et > 0).sum() > 50
    scale = ej.max()
    assert (np.abs(et - ej) > 1e-9 * scale).mean() <= 0.03
    assert np.abs(et - ej).max() <= 1e-6 * scale
    assert tst["captured"] == jst["captured"]
    assert np.abs(timg.numpy() - np.asarray(jimg)).max() < 1e-4


def test_movie_spot_period_carries_the_charge():
    scene = volumetric.SceneConfig(M=1.0, a=A, Q=Q, theta_obs=THETA,
                                   vertical_fov_deg=16.0)
    riaf = volumetric.RIAFConfig(spot_amp=4.0)
    _frames, st = volumetric.render_volumetric_movie(
        scene, (4, 4), (0.0, 10.0), riaf=riaf, device="cpu")
    want = 2.0 * np.pi / abs(float(jvol.keplerian_omega(
        1.0, A, riaf.spot_r, True, Q=Q)))
    assert st["spot_period"] == pytest.approx(want, rel=1e-12)
    assert st["spot_period"] != pytest.approx(2.0 * np.pi / abs(float(
        jvol.keplerian_omega(1.0, A, riaf.spot_r, True))), rel=1e-6)


def test_polarized_volumetric_with_charge_raises_as_jax():
    jscene = JScene(M=1.0, a=A, Q=Q, theta_obs=THETA)
    with pytest.raises(ValueError) as ej:
        jpol.render_polarized_volumetric(jscene, (4, 4), JRender())
    with pytest.raises(ValueError) as et:
        polarization.render_polarized_volumetric(
            scene_from_jax(jscene), (4, 4), device="cpu")
    assert str(et.value) == str(ej.value)
