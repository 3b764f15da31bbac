"""The PyTorch port's volumetric hot-flow path against the JAX package.

128 rays (a = 0.9, alpha in [0.3, 4] alpha_crit, theta_obs = 80 deg,
max_steps 4000), made with numpy from a seed, go through the JAX
`trace_rays_volumetric` (XLA on the CPU) and the port's plain loop, for
the thin torus, the self-absorbed torus (alpha0 = 0.5), the jet (beta
0.6, index -1), the shell and the power law. Criteria:
  * float64: identical statuses; emission and tau within 1e-9 of the
    largest, final_alpha within 1e-9 relative on stable escaped rays;
  * float32: status agreement >= 0.99, p99 |d tau| < 1e-3, and p99
    |d emission| / max below 1e-4 for the torus and the power law,
    1e-3 for the jet and 5e-3 for the shell. Each package's own float32
    integral sits that far from its float64 one (measured p99 over three
    seeds: torus absorbed 4.5e-5 to 9.6e-5, jet 4.0e-4 to 4.9e-4, shell
    1.1e-3 to 3.1e-3), because one ulp of sin/cos changes the step
    sequence and the shell's 0.2 M edges and the jet's narrow cone are
    integrated to the tolerance, not beyond it.
The physics helpers (emissivity, redshift, the covariant t-phi block,
the Keplerian angular velocity) agree to 1e-12 in float64, and the
configuration errors are the JAX package's. The Pallas kernel in
interpret mode and the render entry point are in
tests/test_torch_volumetric_render.py; the CUDA kernel against this loop
runs on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.ops.kerr_trace import (
    trace_rays_volumetric as jtrace)
from light_path_tracer_tpu_torch import disk, volumetric
from light_path_tracer_tpu_torch.convert import riaf_config_from_jax
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

R_OBS = 100.0
THETA = float(np.radians(80.0))

PROFILES = {
    "thin": (dict(), 1e-4),
    "absorbed": (dict(alpha0=0.5), 1e-4),
    "jet": (dict(profile="jet", jet_beta=0.6, index=-1.0), 1e-3),
    "shell": (dict(profile="shell", shell_in=6.0, shell_out=10.0), 5e-3),
    "powerlaw": (dict(profile="powerlaw"), 1e-4),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rays(n, seed):
    ac = JKerr(M=1.0, a=0.9).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(seed)
    return rng.uniform(0.3 * ac, 4 * ac, n), rng.uniform(-np.pi, np.pi, n), ac


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fns(riaf_kwargs):
    jr = jvol.RIAFConfig(**riaf_kwargs)
    tr = riaf_config_from_jax(jr)
    return (jvol.make_transfer_fns(JKerr(M=1.0, a=0.9), jr),
            volumetric.make_transfer_fns(Kerr(M=1.0, a=0.9), tr))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(PROFILES))
def test_plain_volumetric_matches_jax(dtype, name):
    kwargs, bar = PROFILES[name]
    (je, ja), (te, ta) = _fns(kwargs)
    al, th, ac = _rays(128, 0)
    npdt = np.dtype(dtype)
    rj = jtrace(JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al, npdt),
                jnp.asarray(th, npdt), THETA, je, 5000.0, 4000,
                absorption_fn=ja)
    rt = tk.trace_rays_volumetric(
        Kerr(M=1.0, a=0.9), R_OBS, torch.from_numpy(al.astype(npdt)),
        torch.from_numpy(th.astype(npdt)), THETA, te, 5000.0, 4000,
        absorption_fn=ta)
    assert rt.emission.dtype == getattr(torch, dtype)
    sj, st = _np(rj.status), _np(rt.status)
    ej, et = _np(rj.emission), _np(rt.emission)
    tj, tt = _np(rj.optical_depth), _np(rt.optical_depth)
    assert (ej > 0).sum() > 50 and (sj == -1).sum() > 5
    assert (tt > 0).any() == ("alpha0" in kwargs)
    scale = np.abs(ej).max()
    if dtype == "float64":
        np.testing.assert_array_equal(st, sj)
        assert np.abs(et - ej).max() < 1e-9 * scale
        assert np.abs(tt - tj).max() < 1e-9 * max(np.abs(tj).max(), 1.0)
        fj, ft = _np(rj.final_alpha), _np(rt.final_alpha)
        stable = (sj == 1) & (np.abs(al - ac) > 0.05 * ac)
        assert stable.sum() > 50
        assert (np.abs(ft - fj)[stable] / fj[stable]).max() < 1e-9
        np.testing.assert_array_equal(_np(rt.n_half_orbits),
                                      _np(rj.n_half_orbits))
    else:
        ok = sj == st
        assert ok.mean() >= 0.99
        assert np.percentile(np.abs(et - ej)[ok], 99) < bar * scale
        assert np.percentile(np.abs(tt - tj)[ok], 99) < 1e-3


def _points(seed, n=400):
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.5, 30.0, n)
    th = rng.uniform(0.02, np.pi - 0.02, n)
    y5 = np.stack([r, th, rng.uniform(-np.pi, np.pi, n),
                   rng.uniform(-3.0, 3.0, n), rng.uniform(-4.0, 4.0, n)])
    return y5, -np.ones(n), rng.uniform(-6.0, 6.0, n)


@pytest.mark.parametrize("profile", ["torus", "powerlaw", "shell", "jet"])
def test_profile_fns_match_jax(profile):
    """j_rest and the clipped redshift of every profile, pro- and
    retrograde, at a = 0 and 0.9, in float64 at random points."""
    y5, p_t, p_phi = _points(11)
    base = dict(profile=profile, shell_in=3.0, shell_out=12.0,
                jet_beta=0.6 if profile == "jet" else 0.0)
    for a in (0.0, 0.9):
        for prograde in (True, False):
            jr = jvol.RIAFConfig(prograde=prograde, **base)
            jj, jg = jvol._profile_fns(JKerr(M=1.0, a=a), jr)
            tj, tg = volumetric._profile_fns(Kerr(M=1.0, a=a),
                                             riaf_config_from_jax(jr))
            c = np.cos(y5[1])
            np.testing.assert_allclose(
                _np(tj(torch.from_numpy(y5[0]), torch.from_numpy(c))),
                np.asarray(jj(jnp.asarray(y5[0]), jnp.asarray(c))),
                rtol=1e-12, atol=1e-300)
            gj = np.asarray(jg(jnp.asarray(y5), jnp.asarray(p_t),
                               jnp.asarray(p_phi)))
            gt = _np(tg(torch.from_numpy(y5), torch.from_numpy(p_t),
                        torch.from_numpy(p_phi)))
            np.testing.assert_allclose(gt, gj, rtol=1e-12, atol=1e-12)
            assert 0.1 < np.median(gt) < 10.0


def test_flow_helpers_match_jax():
    rng = np.random.default_rng(5)
    r = rng.uniform(1.5, 40.0, 300)
    c = rng.uniform(-1.0, 1.0, 300)
    for M, a in ((1.0, 0.9), (1.0, 0.0), (2.0, -0.5)):
        jg = jdisk.covariant_tphi_components(JKerr(M=M, a=a),
                                             jnp.asarray(r), jnp.asarray(c))
        tg = disk.covariant_tphi_components(Kerr(M=M, a=a),
                                            torch.from_numpy(r),
                                            torch.from_numpy(c))
        for x, y in zip(tg, jg):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12,
                                       atol=1e-12)
        for prograde in (True, False):
            np.testing.assert_allclose(
                disk.keplerian_omega(M, a, torch.from_numpy(r),
                                     prograde).numpy(),
                np.asarray(jdisk.keplerian_omega(M, a, jnp.asarray(r),
                                                 prograde)),
                rtol=1e-12, atol=1e-15)
            assert disk.keplerian_omega(M, a, 6.0, prograde) == pytest.approx(
                float(jdisk.keplerian_omega(M, a, 6.0, prograde)), abs=1e-15)
    # The charged form at Q != 0, on floats (the render raises for Q).
    assert disk.keplerian_omega(1.0, 0.3, 7.0, False, Q=0.4) == pytest.approx(
        float(jdisk.keplerian_omega(1.0, 0.3, 7.0, False, Q=0.4)), abs=1e-15)


def test_validation_errors_match_jax():
    m = Kerr(M=1.0, a=0.9)
    jm = JKerr(M=1.0, a=0.9)
    for kwargs in (dict(profile="disk"), dict(jet_beta=1.0),
                   dict(profile="shell"), dict(alpha0=-1.0)):
        with pytest.raises(ValueError) as ej:
            jvol.make_transfer_fns(jm, jvol.RIAFConfig(**kwargs))
        with pytest.raises(ValueError) as et:
            volumetric.make_transfer_fns(m, volumetric.RIAFConfig(**kwargs))
        assert str(et.value) == str(ej.value)
    scene = SceneConfig(M=1.0, a=0.9)
    with pytest.raises(ValueError, match="Johannsen-Psaltis"):
        volumetric.render_volumetric(
            dataclasses.replace(scene, eps3=0.5), (4, 4), device="cpu")
    # A charged scene is ported (tests/test_torch_charged_volumetric.py),
    # and so is a boosted camera (tests/test_torch_aberration.py).
    for moving in (dataclasses.replace(scene, boost=(0.1, 0.0, 0.0)),):
        img, _ = volumetric.render_volumetric(moving, (4, 4), device="cpu")
        assert bool(torch.isfinite(img).all())
    with pytest.raises(NotImplementedError):
        volumetric.render_volumetric(scene, (4, 4), mesh=object(),
                                     device="cpu")
    with pytest.raises(ValueError):
        volumetric.render_volumetric(scene, (4, 4),
                                     RenderConfig(backend="pallas"),
                                     device="cpu")


def test_cuda_wrapper_runs_plain_version_on_cpu():
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    m = Kerr(M=1.0, a=0.9)
    e, a = volumetric.make_transfer_fns(m, volumetric.RIAFConfig(alpha0=0.5))
    al, th, _ = _rays(32, 8)
    args = (m, R_OBS, torch.from_numpy(al.astype(np.float32)),
            torch.from_numpy(th.astype(np.float32)), THETA, e, 5000.0, 2000)
    launches = vk.trace_rays_volumetric_cuda.launches
    calls = tk.trace_rays_volumetric.launches
    got = vk.trace_rays_volumetric_cuda(*args, absorption_fn=a)
    want = tk.trace_rays_volumetric(*args, absorption_fn=a)
    assert vk.trace_rays_volumetric_cuda.launches == launches
    assert tk.trace_rays_volumetric.launches == calls + 2
    for x, y in zip(got, want):
        assert torch.equal(x.nan_to_num(9.0), y.nan_to_num(9.0))
