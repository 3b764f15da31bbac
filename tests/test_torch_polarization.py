"""The PyTorch port's polarized hot-flow path (Stokes I, Q, U with per-ray
aux inputs) against the JAX package.

Inputs come from numpy seeds and go through both packages. Criteria:
  * the helpers (covariant_metric, k_contravariant, walker_penrose,
    observer_basis) on random points: float64 within 1e-12 of the largest
    value of each output, float32 within 2e-5;
  * the Stokes transfer closure on random states and aux constants, for
    the three field geometries: float64 within 1e-12 of max |dI|, float32
    within 2e-5 (Q and U change sign, so every bar is relative to the
    intensity's scale);
  * trace_rays_aux with the four camera constants on 192 rays (a = 0.9,
    alpha in [0.3, 4] alpha_crit, theta_obs = 80 deg, max_steps 4000)
    against the JAX XLA trace: float64 identical statuses and |d| < 1e-9
    max |I|; float32 status agreement > 0.99 and p99 |d| / max |I| < 1e-4;
    against trace_rays_aux_pallas in interpret mode (one (1, 128) tile, 32
    rays) the float32 bars;
  * the aux two-pass driver over the plain loop equals the single pass
    bitwise (both passes' batch sizes are multiples of 32), so the
    re-traced rays took their aux constants along;
  * render_polarized_volumetric at 24x24 in float64 against the JAX
    render: Stokes maps within 1e-8 of max I (the float64 tier's atol; the
    two libms differ by ulps, which moves an error estimate and with it a
    step), pol_frac within 1e-6, the
    same EVPA where defined; pol_frac <= p0; the image's top-bottom mirror
    symmetry (I, Q even, U odd, to 2 % of the peak) for an equatorial
    observer; and the refusals (psi != 0, a boost, a charge, alpha0 > 0,
    an unknown field, mesh).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import polarization as jpol
from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_aux as jaux
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import polarization, volumetric
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 riaf_config_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

R_OBS = 100.0
THETA = float(np.radians(80.0))
M, A = 1.0, 0.9
BARS = {"float64": 1e-12, "float32": 2e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, bar):
    """Every output within `bar` of its largest reference value."""
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype
        assert np.abs(g - w).max() <= bar * max(np.abs(w).max(), 1e-30)


def _points(n, seed, dtype):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(2.0, 30.0, n), rng.uniform(0.15, 2.95, n),
            rng.uniform(-1.0, 1.0, n), rng.uniform(-3.0, 3.0, n),
            rng.uniform(-4.0, 4.0, n)]
    return [c.astype(dtype) for c in cols]


def _both(cols):
    return ([jnp.asarray(c) for c in cols],
            [torch.from_numpy(c) for c in cols])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_metric_and_photon_helpers_match_jax(dtype):
    (rj, thj, prj, pthj, lj), (rt, tht, prt, ptht, lt) = _both(
        _points(256, 0, dtype))
    bar = BARS[dtype]
    _close(polarization.covariant_metric(M, A, rt, tht),
           jpol.covariant_metric(M, A, rj, thj), bar)
    kj = jpol.k_contravariant(M, A, rj, thj, prj, pthj, lj)
    kt = polarization.k_contravariant(M, A, rt, tht, prt, ptht, lt)
    _close(kt, kj, bar)
    fj, ft = _both(_points(256, 1, dtype)[:4])
    _close(polarization.walker_penrose(A, rt, tht, kt, ft),
           jpol.walker_penrose(A, rj, thj, kj, fj), bar)
    assert len(polarization._PERMS) == 24
    assert polarization._PERMS == [(tuple(p), s) for p, s in jpol._PERMS]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_observer_basis_and_camera_constants_match_jax(dtype):
    npdt = np.dtype(dtype)
    ac = JKerr(M=M, a=A).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(2)
    al = rng.uniform(0.3 * ac, 4 * ac, 128).astype(npdt)
    th = rng.uniform(-np.pi, np.pi, 128).astype(npdt)
    jm, tm = JKerr(M=M, a=A), Kerr(M=M, a=A)
    y0, _pt, pphi, _inv = jm.initial_conditions_5d(
        R_OBS, jnp.asarray(al), jnp.asarray(th), THETA)
    Mj, aj = jnp.asarray(M, npdt), jnp.asarray(A, npdt)
    k_cam = jpol.k_contravariant(Mj, aj, y0[0], y0[1], y0[3], y0[4], pphi)
    e1, e2 = jpol.observer_basis(Mj, aj, R_OBS, THETA, k_cam)
    want = (*jpol.walker_penrose(aj, y0[0], y0[1], k_cam, e1),
            *jpol.walker_penrose(aj, y0[0], y0[1], k_cam, e2))
    got = polarization.camera_constants(
        tm, R_OBS, THETA, torch.from_numpy(al), torch.from_numpy(th))
    assert all(g.dtype == getattr(torch, dtype) and g.is_contiguous()
               for g in got)
    # kappa ~ r_obs x a unit vector: the four share one scale.
    scale = max(np.abs(_np(w)).max() for w in want)
    bar = 1e-11 if dtype == "float64" else 5e-5
    for g, w in zip(got, want):
        assert np.abs(_np(g) - _np(w)).max() <= bar * scale
    t0 = torch.from_numpy(np.stack([_np(c) for c in y0]).astype(npdt))
    kt = polarization.k_contravariant(M, A, t0[0], t0[1], t0[3], t0[4],
                                      torch.from_numpy(_np(pphi)))
    _close([c for e in polarization.observer_basis(M, A, R_OBS, THETA, kt)
            for c in e],
           [c for e in jpol.observer_basis(M, A, R_OBS, THETA, tuple(
               jnp.asarray(_np(c)) for c in kt)) for c in e],
           1e-11 if dtype == "float64" else 5e-5)


def _transfers(field, p0=0.7, **riaf_kw):
    jr = jvol.RIAFConfig(**riaf_kw)
    return (jpol.make_polarized_volumetric_transfer(JKerr(M=M, a=A), jr,
                                                    field, p0),
            polarization.make_polarized_volumetric_transfer(
                Kerr(M=M, a=A), riaf_config_from_jax(jr), field, p0))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("field", ["vertical", "toroidal", "radial"])
def test_stokes_closure_matches_jax(field, dtype):
    rng = np.random.default_rng(3)
    n = 256
    r, th, p_r, p_th, L = _points(n, 4, dtype)
    y = [r, th, rng.uniform(-6, 6, n).astype(dtype), p_r, p_th] + [
        rng.uniform(0, 2, n).astype(dtype) for _ in range(3)]
    aux = [rng.uniform(-80, 80, n).astype(dtype) for _ in range(4)]
    aux[0][:4] = 0.0                       # a degenerate camera basis
    aux[2][:4] = 0.0
    p_t = -np.ones(n, dtype)
    for kw in (dict(), dict(g_power=0.0, prograde=False)):
        jt, tt = _transfers(field, **kw)
        want = jt(tuple(jnp.asarray(c) for c in y), jnp.asarray(p_t),
                  jnp.asarray(L), tuple(jnp.asarray(c) for c in aux))
        got = tt(torch.from_numpy(np.stack(y)), torch.from_numpy(p_t),
                 torch.from_numpy(L), tuple(torch.from_numpy(c)
                                            for c in aux))
        scale = np.abs(_np(want[0])).max()
        for g, w in zip(got, want):
            assert np.abs(_np(g) - _np(w)).max() <= BARS[dtype] * scale
        assert np.all(_np(got[1])[:4] == 0.0)
    assert tt.kernel.kind == "stokes" and tt.kernel.field == field


def _rays(n, seed, dtype):
    ac = JKerr(M=M, a=A).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3 * ac, 4 * ac, n).astype(dtype),
            rng.uniform(-np.pi, np.pi, n).astype(dtype))


def _check_trace(rj, rt, exact):
    sj, st = _np(rj.status), _np(rt.status)
    scale = np.abs(_np(rj.extras[0])).max()
    assert (np.abs(_np(rt.extras[1])) > 0).sum() > 10
    if exact:
        np.testing.assert_array_equal(st, sj)
        for a, b in zip(rj.extras, rt.extras):
            assert np.abs(_np(a) - _np(b)).max() < 1e-9 * scale
        return
    ok = sj == st
    assert ok.mean() > 0.99
    for a, b in zip(rj.extras, rt.extras):
        assert np.percentile(np.abs(_np(a) - _np(b))[ok], 99) < 1e-4 * scale


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_aux_trace_matches_jax(dtype):
    al, th = _rays(192, 5, dtype)
    jt, tt = _transfers("toroidal")
    tm = Kerr(M=M, a=A)
    aux = polarization.camera_constants(tm, R_OBS, THETA,
                                        torch.from_numpy(al),
                                        torch.from_numpy(th))
    rj = jaux(JKerr(M=M, a=A), R_OBS, jnp.asarray(al), jnp.asarray(th),
              THETA, jt, 3, tuple(jnp.asarray(_np(k)) for k in aux), 5000.0,
              4000)
    rt = tk.trace_rays_aux(tm, R_OBS, torch.from_numpy(al),
                           torch.from_numpy(th), THETA, tt, 3, aux, 5000.0,
                           4000)
    assert rt.extras[0].dtype == getattr(torch, dtype)
    _check_trace(rj, rt, dtype == "float64")


def test_plain_aux_trace_matches_pallas_interpret():
    from light_path_tracer_tpu.ops.pallas import volumetric_kernel as jpk
    al, th = _rays(32, 6, np.float32)
    jt, tt = _transfers("vertical")
    tm = Kerr(M=M, a=A)
    aux = polarization.camera_constants(tm, R_OBS, THETA,
                                        torch.from_numpy(al),
                                        torch.from_numpy(th))
    rp = jpk.trace_rays_aux_pallas(
        JKerr(M=M, a=A), R_OBS, jnp.asarray(al), jnp.asarray(th), THETA, jt,
        3, tuple(jnp.asarray(_np(k)) for k in aux), 5000.0, 4000,
        tile_rows=1, interpret=True)
    rt = vk.trace_rays_aux_cuda(tm, R_OBS, torch.from_numpy(al),
                                torch.from_numpy(th), THETA, tt, 3, aux,
                                5000.0, 4000)
    _check_trace(rp, rt, False)


def test_aux_two_pass_over_plain_loop_equals_single_pass():
    ac = Kerr(M=M, a=A).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(7)
    al = torch.from_numpy(rng.uniform(0.9 * ac, 1.1 * ac, 64)
                          .astype(np.float32))
    th = torch.from_numpy(rng.uniform(-np.pi, np.pi, 64).astype(np.float32))
    tm = Kerr(M=M, a=A)
    _jt, tt = _transfers("toroidal")
    aux = polarization.camera_constants(tm, R_OBS, THETA, al, th)
    args = (tm, R_OBS, al, th, THETA, tt, 3, aux, 5000.0, 4000)
    plain = tk.trace_rays_aux.launches
    _one, unconv = vk.trace_rays_aux_cuda(*args[:9], 48,
                                          return_unconverged=True)
    assert 0 < int(unconv.sum()) <= 32
    full = vk.trace_rays_aux_cuda(*args)
    two = kk.trace_rays_aux_two_pass(*args, pass1_steps=48, slots=32)
    assert tk.trace_rays_aux.launches == plain + 4
    for a, b in zip((*full.extras, full.status, full.final_alpha),
                    (*two.extras, two.status, two.final_alpha)):
        assert torch.equal(a.nan_to_num(9.0), b.nan_to_num(9.0))
    assert int(two.n_steps) > int(full.n_steps)
    # Without their own constants the stragglers' Q and U would come out
    # differently: a re-trace with ray 0's constants does not match.
    idx = torch.nonzero(unconv)[:, 0]
    wrong = vk.trace_rays_aux_cuda(
        tm, R_OBS, al[idx], th[idx], THETA, tt, 3,
        tuple(k[:1].expand(idx.numel()).contiguous() for k in aux), 5000.0,
        4000)
    assert not torch.equal(wrong.extras[1], full.extras[1][idx])


def test_render_polarized_matches_jax_and_is_mirror_symmetric():
    jscene = JScene(M=M, a=A, r_obs_mult=R_OBS, vertical_fov_deg=16.0,
                    theta_obs=THETA)
    jcfg = JRender(dtype="float64", backend="xla")
    jr = jvol.RIAFConfig()
    je, jp, ji, jst = jpol.render_polarized_volumetric(
        jscene, (24, 24), jcfg, jr, field="vertical", p0=0.6)
    te, tp, ti, tst = polarization.render_polarized_volumetric(
        scene_from_jax(jscene), (24, 24), render_cfg_from_jax(jcfg),
        riaf_config_from_jax(jr), field="vertical", p0=0.6, device="cpu")
    assert set(tst) == set(jst)
    peak = ji.max()
    for key in "IQU":
        assert np.abs(tst[key] - jst[key]).max() < 1e-8 * peak
    bright = ji > 1e-6 * peak
    assert np.abs(tp - jp)[bright].max() < 1e-6
    np.testing.assert_array_equal(np.isnan(te), np.isnan(je))
    d = np.abs(np.angle(np.exp(2j * (te - je))))[bright & ~np.isnan(je)]
    assert d.max() < 1e-6
    assert te.dtype == tp.dtype == np.float64 and ti.shape == (24, 24)
    for key in ("captured", "invalid", "total_rays"):
        assert tst[key] == jst[key]
    assert tp[bright].max() <= 0.6 + 1e-9 and tp[bright].min() >= 0.0
    # An equatorial observer sees a top-bottom mirror image: I and Q
    # even, U odd.
    scene = SceneConfig(M=M, a=A, r_obs_mult=R_OBS, vertical_fov_deg=16.0)
    _e, _p, inten, st = polarization.render_polarized_volumetric(
        scene, (24, 24), RenderConfig(max_steps=20000), field="toroidal",
        device="cpu")
    top = slice(1, 12)
    bottom = slice(23, 12, -1)
    peak = inten.max()
    assert np.abs(st["I"][top] - st["I"][bottom]).max() < 0.02 * peak
    assert np.abs(st["Q"][top] - st["Q"][bottom]).max() < 0.02 * peak
    assert np.abs(st["U"][top] + st["U"][bottom]).max() < 0.02 * peak
    assert np.abs(st["Q"]).max() > 0.05 * peak


@pytest.mark.parametrize("bad, error", [
    (dict(scene=dict(psi_y=0.01)), ValueError),
    (dict(scene=dict(boost=(0.1, 0.0, 0.0))), ValueError),
    (dict(scene=dict(Q=0.3, a=0.0)), ValueError),
    (dict(riaf=dict(alpha0=0.2)), ValueError),
    (dict(field="helical"), ValueError),
    (dict(mesh=object()), NotImplementedError)])
def test_render_polarized_refusals(bad, error):
    scene = dataclasses.replace(SceneConfig(M=M, a=A), **bad.get("scene", {}))
    riaf = volumetric.RIAFConfig(**bad.get("riaf", {}))
    with pytest.raises(error):
        polarization.render_polarized_volumetric(
            scene, (4, 4), RenderConfig(), riaf,
            field=bad.get("field", "toroidal"), mesh=bad.get("mesh"),
            device="cpu")


def test_stokes_kernel_constants_and_layout():
    """The kernel's structs mirror csrc/kerr_dp45_extras.cuh (240 and 216
    bytes for the float instances, 472 and 272 for the float64 ones:
    ExtrasCall carries the metric family and Q^2), and the Stokes
    constants are Python floats formed in double and rounded once."""
    import ctypes
    assert ctypes.sizeof(vk.RiafParams) == 240
    assert ctypes.sizeof(vk.ExtrasCall) == 216
    assert ctypes.sizeof(vk.RiafParams64) == 472
    assert ctypes.sizeof(vk.ExtrasCall64) == 272
    m = Kerr(M=2.0, a=0.6)
    tt = polarization.make_polarized_volumetric_transfer(
        m, volumetric.RIAFConfig(prograde=False), "radial", 0.65)
    p = vk.riaf_params(tt.kernel)
    f32 = np.float32
    assert p.field == 2 and p.p0 == f32(0.65) and p.flow_sign == -1.0
    assert p.two_Ma == f32(2.0 * 2.0 * 0.6)
    assert p.two_Ma2 == f32(2.0 * 2.0 * 0.6 * 0.6)
    assert p.kep_num == f32(-np.sqrt(2.0))
    assert p.kep_add == f32(-(0.6 * np.sqrt(2.0)))
    assert vk._family(tt.kernel, 3, 4) == ("lpt_kerr_dp45_stokes", 0, 0)
    with pytest.raises(ValueError, match="aux"):
        vk._family(tt.kernel, 3, 0)
    with pytest.raises(ValueError, match="extras"):
        vk._family(tt.kernel, 4, 4)


def test_cli_polarization_on_cpu(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png
    out = tmp_path / "p.png"
    assert main(["volumetric", "--size", "16", "--a", "0.9", "--theta-obs",
                 "80", "--fov-v", "16", "--device", "cpu", "--polarization",
                 str(out), "--b-field", "vertical"]) == 0
    text = capsys.readouterr().out
    assert "Polarized volumetric (vertical): 16x16" in text
    assert "mean pol fraction" in text
    assert read_png(out).shape == (16, 16, 3)
    assert read_png(tmp_path / "p_pol_frac.png").shape == (16, 16, 3)
    data = np.load(tmp_path / "p.npz")
    assert set(data.files) == {"evpa", "pol_frac", "I", "Q", "U"}
    frac = data["pol_frac"][data["I"] > 1e-6 * data["I"].max()]
    assert frac.max() <= 0.7 + 1e-6
    with pytest.raises(ValueError, match="PNG"):
        main(["volumetric", "--size", "8", "--device", "cpu",
              "--polarization", str(tmp_path / "p.pdf")])
