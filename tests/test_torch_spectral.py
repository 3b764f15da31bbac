"""The PyTorch port's multi-frequency spectral path and the volumetric CLI
against the JAX package.

128 rays (a = 0.9, alpha in [0.3, 4] alpha_crit, theta_obs = 80 deg,
max_steps 4000), made with numpy from a seed, go through the JAX
`trace_rays_spectral` (XLA on the CPU) and the port's plain loop with two
bands (0.5, 2.0), g_power 4, alpha0 1, opacity index 2. Criteria:
  * float64: identical statuses, tau_hat and each band within 1e-9 of
    its largest value;
  * float32: status agreement >= 0.99, p99 |d band| / max < 1e-4 and
    p99 |d tau_hat| / max < 2e-4. tau_hat reaches ~12 here, and each
    package's own float32 tau_hat sits 4.4e-4 to 1.2e-3 (p99, three
    seeds) from its float64 one, so the volumetric path's absolute 1e-3
    on tau becomes a bar relative to the largest tau_hat.
The Pallas extras tile kernel (trace_rays_spectral_pallas and
trace_rays_aux_pallas with no aux inputs, interpret mode, one (1, 128)
tile) on 32 float32 rays holds to the same float32 bars.
render_volumetric_spectrum at 16x16 with three bands matches the JAX
render in float64 (images to 1e-6, emission and tau_hat to 1e-9 of the
largest, the same flux, radii and spectral-index maps); the SSA turnover
and the band scaling hold on the port's CPU path. The `volumetric` CLI
renders a still and a band panel on the CPU, registers every JAX flag
with its default, writes the visibility and centroid reports, and runs
charged scenes in every mode.
"""

import argparse
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_spectral as jspec
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import volumetric
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 riaf_config_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

R_OBS = 100.0
THETA = float(np.radians(80.0))
FREQS = (0.5, 2.0)
RIAF = dict(g_power=4.0, alpha0=1.0, opacity_index=2.0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rays(n, seed):
    ac = JKerr(M=1.0, a=0.9).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(seed)
    return rng.uniform(0.3 * ac, 4 * ac, n), rng.uniform(-np.pi, np.pi, n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _transfers(freqs=FREQS, **kwargs):
    jr = jvol.RIAFConfig(**(kwargs or RIAF))
    return (jvol.make_spectral_transfer(JKerr(M=1.0, a=0.9), jr, freqs),
            volumetric.make_spectral_transfer(
                Kerr(M=1.0, a=0.9), riaf_config_from_jax(jr), freqs))


def _check(rj, rt, exact):
    """rj, rt: JAX and port SpectralResult on the same rays."""
    sj, st = _np(rj.status), _np(rt.status)
    pairs = [(_np(rj.tau_hat), _np(rt.tau_hat), 2e-4)] + [
        (_np(a), _np(b), 1e-4) for a, b in zip(rj.emission, rt.emission)]
    assert all((b > 0).sum() > 10 for _, b, _ in pairs)
    if exact:
        np.testing.assert_array_equal(st, sj)
        for a, b, _ in pairs:
            assert np.abs(a - b).max() < 1e-9 * np.abs(a).max()
        return
    ok = sj == st
    assert ok.mean() >= 0.99
    for a, b, bar in pairs:
        d = np.abs(a - b)[ok]
        assert np.percentile(d, 99) < bar * np.abs(a).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_spectral_matches_jax(dtype):
    jt, tt = _transfers()
    al, th = _rays(128, 0)
    npdt = np.dtype(dtype)
    rj = jspec(JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al, npdt),
               jnp.asarray(th, npdt), THETA, jt, len(FREQS), 5000.0, 4000)
    rt = tk.trace_rays_spectral(
        Kerr(M=1.0, a=0.9), R_OBS, torch.from_numpy(al.astype(npdt)),
        torch.from_numpy(th.astype(npdt)), THETA, tt, len(FREQS), 5000.0,
        4000)
    assert rt.tau_hat.dtype == getattr(torch, dtype)
    assert len(rt.emission) == len(FREQS)
    _check(rj, rt, dtype == "float64")


@pytest.mark.parametrize("entry", ["spectral", "aux"])
def test_plain_spectral_matches_pallas_interpret(entry):
    """The Pallas extras tile kernel in interpret mode, through
    trace_rays_spectral_pallas and through trace_rays_aux_pallas with no
    aux inputs (the spectral state as generic extras)."""
    from light_path_tracer_tpu.ops.pallas import volumetric_kernel as jpk
    from light_path_tracer_tpu.ops.types import SpectralResult as JSpec
    jt, tt = _transfers()
    al, th = _rays(32, 3)
    al, th = al.astype(np.float32), th.astype(np.float32)
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    args = (R_OBS, jnp.asarray(al), jnp.asarray(th), THETA, jt)
    targs = (R_OBS, torch.from_numpy(al), torch.from_numpy(th), THETA, tt)
    kw = dict(tile_rows=1, interpret=True)
    if entry == "spectral":
        rp = jpk.trace_rays_spectral_pallas(jm, *args, 2, 5000.0, 4000, **kw)
        rt = tk.trace_rays_spectral(tm, *targs, 2, 5000.0, 4000)
    else:
        xp = jpk.trace_rays_aux_pallas(jm, *args, 3, (), 5000.0, 4000, **kw)
        xt = tk.trace_rays_aux(tm, *targs[:4],
                               lambda y, pt, pp, aux: tt(y, pt, pp), 3, (),
                               5000.0, 4000)
        rp = JSpec(xp.extras[1:], xp.extras[0], *xp[1:])
        rt = tk.spectral_result(xt)
    _check(rp, rt, False)


def test_render_spectrum_matches_jax():
    jscene = JScene(M=1.0, a=0.9, r_obs_mult=R_OBS, vertical_fov_deg=16.0,
                    theta_obs=THETA)
    jcfg = JRender(dtype="float64", backend="xla")
    jr = jvol.RIAFConfig(g_power=4.0, alpha0=1.0, opacity_index=3.0)
    freqs = (0.1, 1.0, 10.0)
    jimgs, jst = jvol.render_volumetric_spectrum(jscene, (16, 16), freqs,
                                                 jcfg, jr)
    timgs, tst = volumetric.render_volumetric_spectrum(
        scene_from_jax(jscene), (16, 16), freqs, render_cfg_from_jax(jcfg),
        riaf_config_from_jax(jr), device="cpu")
    assert timgs.dtype == torch.float32 and timgs.shape == (3, 16, 16)
    assert set(tst) == set(jst)
    assert np.abs(timgs.numpy() - np.asarray(jimgs)).max() < 1e-6
    for key in ("captured", "invalid", "total_rays", "traced_rays"):
        assert tst[key] == jst[key]
    np.testing.assert_array_equal(tst["freqs"], jst["freqs"])
    em = jst["emission"]
    assert np.abs(tst["emission"] - em).max() < 1e-9 * em.max()
    assert np.abs(tst["tau_hat"] - jst["tau_hat"]).max() \
        < 1e-9 * jst["tau_hat"].max()
    np.testing.assert_allclose(tst["flux"], jst["flux"], rtol=1e-9)
    np.testing.assert_allclose(tst["mean_radius_rad"],
                               jst["mean_radius_rad"], rtol=1e-9)
    for a, b in zip(tst["spectral_index"], jst["spectral_index"]):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   rtol=1e-6, atol=1e-9)
    scene = scene_from_jax(jscene)
    for bad in ((), (1.0, -2.0)):
        with pytest.raises(ValueError, match="freqs"):
            volumetric.render_volumetric_spectrum(scene, (4, 4), bad,
                                                  device="cpu")


def test_ssa_turnover_and_band_scaling():
    """Opacity index q > s: the spectrum rises on the thick side and falls
    on the thin side, and the photosphere grows toward low frequency.
    Without absorption the bands are f^-s copies of one integral."""
    scene = SceneConfig(M=1.0, a=0.9, theta_obs=THETA, vertical_fov_deg=16.0)
    cfg = RenderConfig(max_steps=20000)
    riaf = volumetric.RIAFConfig(g_power=4.0, alpha0=1.0, opacity_index=3.0)
    _imgs, st = volumetric.render_volumetric_spectrum(
        scene, (32, 32), (0.1, 1.0, 10.0), cfg, riaf, device="cpu")
    flux, r = st["flux"], st["mean_radius_rad"]
    assert flux[1] > 2.0 * flux[0] and flux[1] > 2.0 * flux[2]
    assert r[0] > r[1] > r[2]
    a_thick, a_thin = st["spectral_index"]
    w = st["emission"][1]
    assert np.nansum(a_thick * w) / np.nansum(
        np.where(np.isfinite(a_thick), w, 0.0)) < -0.2
    assert np.nansum(a_thin * w) / np.nansum(
        np.where(np.isfinite(a_thin), w, 0.0)) > 0.2
    _imgs, st = volumetric.render_volumetric_spectrum(
        scene, (16, 16), (0.5, 1.0, 2.0), cfg,
        volumetric.RIAFConfig(g_power=4.0), device="cpu")
    em = st["emission"]
    tiny = 1e-12 * em[1].max()
    np.testing.assert_allclose(em[0], 2.0 * em[1], rtol=1e-6, atol=tiny)
    np.testing.assert_allclose(em[2], 0.5 * em[1], rtol=1e-6, atol=tiny)


def test_kernel_constants_are_rounded_once():
    """The kernel's constants are the JAX closures' Python floats, formed
    in double and rounded to float32 once."""
    m = Kerr(M=2.0, a=0.6)
    riaf = volumetric.RIAFConfig(profile="jet", sigma_r=1.3, h_cos=0.35,
                                 jet_sigma=0.07, jet_beta=0.6,
                                 opacity_index=3.0, prograde=False)
    p = vk.riaf_params(volumetric.make_spectral_transfer(
        m, riaf, (0.1, 1.0, 10.0)).kernel)
    f32 = np.float32
    assert p.two_sig_r2 == f32(2.0 * 1.3 ** 2)
    assert p.two_h2 == f32(2.0 * 0.35 ** 2)
    assert p.two_jet_sig2 == f32(2.0 * 0.07 ** 2)
    assert p.jet_gamma == f32(1.0 / np.sqrt(1.0 - 0.36))
    assert p.kep_num == f32(-np.sqrt(2.0))
    assert p.kep_add == f32(-(0.6 * np.sqrt(2.0)))
    assert p.two_M == 4.0 and p.a2 == f32(0.36) and p.profile == 3
    assert list(p.neg_c)[:3] == [f32(-(f ** -2.0)) for f in (0.1, 1.0, 10.0)]
    assert list(p.band_scale)[:3] == [f32(f ** -0.0) for f in (0.1, 1.0,
                                                                10.0)]
    assert p.tau_floor == f32(-30.0 / 100.0000000000000)
    thin = volumetric.make_transfer_fns(m, riaf)[0].kernel
    assert vk.riaf_params(thin).tau_floor == 0.0
    assert thin.constants()["c"] == ()


def test_cuda_wrappers_run_plain_versions_on_cpu():
    _jt, tt = _transfers()
    al, th = _rays(32, 4)
    m = Kerr(M=1.0, a=0.9)
    args = (m, R_OBS, torch.from_numpy(al.astype(np.float32)),
            torch.from_numpy(th.astype(np.float32)), THETA)
    launches = vk.trace_rays_aux_cuda.launches
    plain = tk.trace_rays_spectral.launches
    got = vk.trace_rays_spectral_cuda(*args, tt, 2, 5000.0, 2000)
    want = tk.trace_rays_spectral(*args, tt, 2, 5000.0, 2000)
    assert vk.trace_rays_aux_cuda.launches == launches
    assert tk.trace_rays_spectral.launches == plain + 2
    for x, y in zip(got.emission + (got.tau_hat, got.status),
                    want.emission + (want.tau_hat, want.status)):
        assert torch.equal(x, y)
    aux = vk.trace_rays_aux_cuda(*args, tt, 3, (), 5000.0, 2000)
    for x, y in zip(aux.extras, (want.tau_hat,) + want.emission):
        assert torch.equal(x, y)


def test_cli_volumetric_on_cpu(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png
    common = ["volumetric", "--size", "24", "--a", "0.9", "--theta-obs",
              "80", "--fov-v", "16", "--device", "cpu"]
    out = tmp_path / "v.png"
    assert main(common + ["--alpha0", "0.3", "--output", str(out)]) == 0
    text = capsys.readouterr().out
    assert "Volumetric (torus): 24x24, a=0.9" in text and "rays/s" in text
    assert "max optical depth" in text and f"Saved: {out}" in text
    img = read_png(out)
    assert img.shape == (24, 24, 3) and img.max() > 0.5
    assert (img[..., 0] >= img[..., 1]).all()          # afmhot
    out2 = tmp_path / "s.png"
    assert main(common + ["--freqs", "0.1,1,10", "--g-power", "4",
                          "--alpha0", "1", "--opacity-index", "3",
                          "--output", str(out2)]) == 0
    text = capsys.readouterr().out
    assert "Spectral volumetric: 3 bands in one trace" in text
    assert read_png(out2).shape == (24, 3 * 24 + 4, 3)
    sed = np.load(tmp_path / "s_spectrum.npz")
    assert set(sed.files) == {"freqs", "flux", "mean_radius_rad",
                              "spectral_index"}
    assert sed["spectral_index"].shape == (2, 24, 24)
    np.testing.assert_array_equal(sed["freqs"], [0.1, 1.0, 10.0])


@pytest.mark.parametrize("flags", [
    ["--movie", "4", "--centroid", "x.png"],
    ["--polarization", "x.png", "--visibility", "x.npz"],
    ["--visibility", "x.npz"], ["--centroid", "x.png"]])
def test_cli_volumetric_rejects_modes_not_ported(tmp_path, flags):
    # The centroid and visibility reports are ported: the movie's track
    # is written as CSV beside its name, the still image's |V| profile as
    # .npz; each is ignored where the JAX CLI ignores it.
    from light_path_tracer_tpu_torch.cli import main
    argv = [str(tmp_path / f) if f.endswith((".png", ".npz")) else f
            for f in flags]
    assert main(["volumetric", "--size", "8", "--device", "cpu",
                 "--output", str(tmp_path / "v.png"), *argv]) == 0
    if "--movie" in flags:
        assert np.loadtxt(tmp_path / "x.csv", delimiter=",").shape == (4, 4)
    if flags == ["--visibility", "x.npz"]:
        assert set(np.load(tmp_path / "x.npz").files) == {
            "baselines", "amp", "b_null", "diameter_rad", "model"}


@pytest.mark.parametrize("mode", ["thin", "decompose"])
def test_cli_volumetric_charged(tmp_path, capsys, mode):
    """--Q runs the charged (Kerr-Newman) flow: the still image and the
    order decomposition at 8^2 on the CPU."""
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png
    out = tmp_path / "v.png"
    extra = (["--decompose", str(tmp_path / "d.png")] if mode == "decompose"
             else [])
    assert main(["volumetric", "--size", "8", "--device", "cpu", "--Q",
                 "0.3", "--output", str(out), *extra]) == 0
    text = capsys.readouterr().out
    if mode == "decompose":
        assert (tmp_path / "d_composite.png").exists()
        layers = np.load(tmp_path / "d.npz")
        assert all(np.isfinite(layers[k]).all() for k in layers.files)
    else:
        assert f"Saved: {out}" in text
        assert read_png(out).shape == (8, 8, 3)


def test_volumetric_parser_defaults_match_jax():
    from light_path_tracer_tpu.cli import volumetric as jcli
    from light_path_tracer_tpu_torch.cli import volumetric as tcli

    def defaults(mod):
        parser = argparse.ArgumentParser()
        mod.register(parser.add_subparsers(dest="command"))
        return vars(parser.parse_args(["volumetric"]))

    dj, dt = defaults(jcli), defaults(tcli)
    dj.pop("fn"), dt.pop("fn")
    shared = {"device", "bilinear", "sampling", "metric_py"}
    for key in set(dj) - shared:
        assert key in dt, key
        assert dt[key] == dj[key], key


def test_riaf_config_from_jax_round_trips():
    jr = jvol.RIAFConfig(profile="jet", r_peak=5.0, sigma_r=2.0, h_cos=0.2,
                         index=-1.0, g_power=4.0, prograde=False,
                         tone_map="asinh", alpha0=0.7, opacity_index=3.5,
                         jet_cos=0.8, jet_sigma=0.05, jet_beta=0.5,
                         jet_r_base=3.0)
    tr = riaf_config_from_jax(jr)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert [f.name for f in dataclasses.fields(tr)] == [
        f.name for f in dataclasses.fields(jr)]
    assert riaf_config_from_jax(jvol.RIAFConfig()) == volumetric.RIAFConfig()
