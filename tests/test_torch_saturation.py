"""The saturation and frozen-state exits of the port's extras loop, and the
two-pass drivers over the volumetric and spectral traces.

The exits (ops/kerr_trace.py dp45_integrate, sat_window): a lane whose
monitored extras have not changed bitwise for sat_window consecutive
attempts while r <= 1.2 x the outermost unstable photon orbit, or whose
whole state has not changed for sat_window attempts anywhere, ends with
lambda = lambda_max. The cases are the JAX package's
(tests/test_saturation.py): the band bound; the exit fires on a fan of
boundary rays with a zero integrand (an emission shell outside the
camera); the band guard keeps far-field rays running; sat_window without
a monitor raises; the default window of 2048 is a bitwise no-op on a
clean 32x32 scene; a lane ended by the exit is not unconverged.

The drivers (ops/cuda/kerr_trace_kernel.py) over the plain loop, with
alpha clustered at (0.9-1.1) alpha_crit so that a 48-attempt first pass
leaves rays running (the slowest of these 256 rays needs 76 attempts): bitwise equal to one uncapped pass when at most
`slots` rays are unconverged, and rays beyond `slots` keep their
first-pass result. Batch sizes are multiples of 32, where PyTorch's
vectorised and scalar transcendentals agree.
"""

import dataclasses

import numpy as np
import pytest
import torch

from light_path_tracer_tpu_torch import volumetric
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

METRIC = Kerr(M=1.0, a=0.9)
R_OBS = 100.0
THETA = float(np.radians(80.0))
# The float32 capture-boundary alpha at screen azimuth 0 of this scene
# (the JAX package's tests/test_saturation.py).
ALPHA_BOUNDARY = 0.04788942448789385
SCENE = SceneConfig(M=1.0, a=0.9, theta_obs=THETA, vertical_fov_deg=16.0)
CFG = RenderConfig(max_steps=20000)
CFG_OFF = dataclasses.replace(CFG, sat_window=0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _boundary_fan(n=9):
    base = np.float32(ALPHA_BOUNDARY)
    return torch.tensor([base + k * np.float32(abs(base) * 6e-8)
                         for k in range(-(n // 2), n - n // 2)],
                        dtype=torch.float32)


def _empty_shell():
    """An emission shell outside the camera radius: the integrand is zero
    during any photon-shell dwell."""
    riaf = volumetric.RIAFConfig(profile="shell", shell_in=150.0,
                                 shell_out=160.0, g_power=0.0)
    return volumetric.make_transfer_fns(METRIC, riaf)[0]


def test_saturation_r_max_band():
    r_pro, r_retro = METRIC.unstable_photon_radii()
    assert tk.saturation_r_max(METRIC) == pytest.approx(1.2 * r_retro)
    assert tk.saturation_r_max(METRIC) < 6.0


def test_exit_fires_for_in_band_no_change_lanes():
    em = _empty_shell()
    al = _boundary_fan()
    args = (METRIC, R_OBS, al, torch.zeros_like(al), THETA, em, 5000.0,
            200000)
    off = tk.trace_rays_volumetric(*args, precision="gate", sat_window=0)
    on, unconv = tk.trace_rays_volumetric(*args, precision="gate",
                                          sat_window=8,
                                          return_unconverged=True)
    assert int(on.n_steps) < int(off.n_steps) // 2
    assert not bool(unconv.any())
    assert torch.equal(on.emission, torch.zeros_like(on.emission))


def test_band_guard_blocks_far_field_exit():
    em = _empty_shell()
    al = torch.linspace(0.15, 0.3, 8, dtype=torch.float32)
    args = (METRIC, R_OBS, al, torch.zeros_like(al), THETA, em, 5000.0,
            200000)
    off = tk.trace_rays_volumetric(*args, sat_window=0)
    on = tk.trace_rays_volumetric(*args, sat_window=8)
    assert int(on.n_steps) == int(off.n_steps)
    assert torch.equal(on.status, off.status)
    assert torch.equal(on.emission, off.emission)


def test_sat_window_requires_monitor():
    ones = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="sat_monitor"):
        tk.dp45_integrate(
            METRIC, torch.ones((6, 4), dtype=torch.float64), -ones, ones,
            torch.full((4,), 2, dtype=torch.int32),
            atol=torch.full((4,), 1e-5), rtol=torch.full((4,), 1e-5),
            h_min=torch.tensor(1e-7), tiny_err=1e-8,
            r_capture=torch.tensor(2.0), r_escape=torch.tensor(200.0),
            lambda_max=100.0, h_init=1.0, max_steps=10,
            extra_rhs=lambda y, pt, pp: (y[0] * 0.0,), sat_window=8,
            sat_monitor=())
    with pytest.raises(ValueError, match="sat_monitor"):
        tk.trace_rays_aux(METRIC, R_OBS, ones, ones, THETA,
                          lambda y, pt, pp, aux: (y[0] * 0.0,), 1, (),
                          5000.0, 10, sat_window=8)


@pytest.mark.parametrize("mode", ["thin", "absorbed", "spectral"])
def test_default_window_is_noop_on_clean_scene(mode):
    """The production window (2048 attempts) changes nothing on a clean
    32x32 frame: images and step counts are bitwise those of the exit
    switched off."""
    def render(cfg):
        if mode == "spectral":
            return volumetric.render_volumetric_spectrum(
                SCENE, (32, 32), (0.5, 1.0), cfg,
                volumetric.RIAFConfig(alpha0=1.0), device="cpu")
        riaf = volumetric.RIAFConfig(alpha0=0.3 if mode == "absorbed"
                                     else 0.0)
        return volumetric.render_volumetric(SCENE, (32, 32), cfg, riaf,
                                            device="cpu")
    img_on, st_on = render(CFG)
    img_off, st_off = render(CFG_OFF)
    assert torch.equal(img_on, img_off)
    assert st_on["integrator_steps"] == st_off["integrator_steps"]


def _clustered(n=256, seed=9):
    ac = METRIC.alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(0.9 * ac, 1.1 * ac, n),
                         dtype=torch.float32),
            torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=torch.float32))


def _same(a, b):
    return torch.equal(a.nan_to_num(9.0), b.nan_to_num(9.0))


@pytest.mark.parametrize("form", ["volumetric", "spectral", "aux"])
def test_two_pass_equals_single_pass(form):
    al, th = _clustered()
    args = (METRIC, R_OBS, al, th, THETA)
    if form == "volumetric":
        em, ab = volumetric.make_transfer_fns(
            METRIC, volumetric.RIAFConfig(alpha0=0.4))
        one, unconv = tk.trace_rays_volumetric(
            *args, em, 5000.0, 48, absorption_fn=ab,
            return_unconverged=True)
        one = tk.trace_rays_volumetric(*args, em, 5000.0, 4000,
                                       absorption_fn=ab)
        driver = kk.trace_rays_volumetric_two_pass
        two = driver(*args, em, 5000.0, 4000, absorption_fn=ab,
                     pass1_steps=48, slots=128,
                     trace_fn=tk.trace_rays_volumetric)
        fields = one._fields
    else:
        tf = volumetric.make_spectral_transfer(
            METRIC, volumetric.RIAFConfig(g_power=4.0, alpha0=1.0,
                                          opacity_index=3.0), (0.1, 10.0))
        _, unconv = tk.trace_rays_spectral(*args, tf, 2, 5000.0, 48,
                                           return_unconverged=True)
        one = tk.trace_rays_spectral(*args, tf, 2, 5000.0, 4000)
        if form == "spectral":
            driver = kk.trace_rays_spectral_two_pass
            two = driver(*args, tf, 2, 5000.0, 4000, pass1_steps=256,
                         slots=128, trace_fn=tk.trace_rays_spectral)
        else:
            driver = kk.trace_rays_aux_two_pass
            aux = driver(*args, lambda y, pt, pp, a: tf(y, pt, pp), 3, (),
                         5000.0, 4000, pass1_steps=48, slots=128,
                         trace_fn=tk.trace_rays_aux)
            two = tk.spectral_result(aux)
        fields = one._fields
    assert 0 < int(unconv.sum()) <= 128
    for name, a, b in zip(fields, one, two):
        if name == "n_steps":
            assert int(b) > int(a) > 0
        elif isinstance(a, tuple):
            assert all(_same(x, y) for x, y in zip(a, b)), name
        else:
            assert _same(a, b), name


def test_two_pass_keeps_pass_one_beyond_slots():
    al, th = _clustered()
    args = (METRIC, R_OBS, al, th, THETA)
    em, _ = volumetric.make_transfer_fns(METRIC, volumetric.RIAFConfig())
    one = tk.trace_rays_volumetric(*args, em, 5000.0, 4000)
    first, unconv = tk.trace_rays_volumetric(*args, em, 5000.0, 32,
                                             return_unconverged=True)
    idx = torch.nonzero(unconv)[:, 0]
    assert idx.numel() > 32
    calls = kk.trace_rays_volumetric_two_pass.launches
    two = kk.trace_rays_volumetric_two_pass(
        *args, em, 5000.0, 4000, pass1_steps=32, slots=32,
        trace_fn=tk.trace_rays_volumetric)
    assert kk.trace_rays_volumetric_two_pass.launches == calls + 1
    retraced = torch.zeros_like(unconv)
    retraced[idx[:32]] = True
    for a, b, c in zip(one[:4] + one[5:], two[:4] + two[5:],
                       first[:4] + first[5:]):
        assert _same(b[retraced], a[retraced])
        assert _same(b[~retraced], c[~retraced])


def test_render_two_pass_rule(monkeypatch):
    """cfg.two_pass 'auto' and True run the driver, False the single
    pass, for both renders (the JAX package's rule)."""
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    calls = []

    def spy(name, fn):
        def run(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        run.launches = 0
        return run

    for name in ("trace_rays_volumetric_two_pass",
                 "trace_rays_spectral_two_pass"):
        monkeypatch.setattr(kk, name, spy(name, getattr(kk, name)))
    for name in ("trace_rays_volumetric_cuda", "trace_rays_spectral_cuda"):
        monkeypatch.setattr(vk, name, spy(name, getattr(vk, name)))
    cfg = RenderConfig(max_steps=2000)
    for two_pass in ("auto", True, False):
        c = dataclasses.replace(cfg, two_pass=two_pass)
        volumetric.render_volumetric(SCENE, (4, 4), c, device="cpu")
        volumetric.render_volumetric_spectrum(SCENE, (4, 4), (1.0,), c,
                                              device="cpu")
    driver = ["trace_rays_volumetric_two_pass",
              "trace_rays_volumetric_cuda", "trace_rays_volumetric_cuda",
              "trace_rays_spectral_two_pass",
              "trace_rays_spectral_cuda", "trace_rays_spectral_cuda"]
    assert calls == driver * 2 + ["trace_rays_volumetric_cuda",
                                  "trace_rays_spectral_cuda"]
