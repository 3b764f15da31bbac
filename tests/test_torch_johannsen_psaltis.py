"""The port's Johannsen-Psaltis family against the JAX package's.

The same inputs, made with numpy from a seed, go through both packages;
JAX runs its XLA branch (or its Pallas kernel in interpret mode), the
port its plain loops on the CPU. Criteria:
  * rhs5 against JAX's hand form: float64 within 1e-12 of each
    component's largest magnitude, float32 within 1e-6 of it; against
    JAX's jax.grad oracle at the oracle test's own bar (elementwise
    relative 1e-8), eps3 negative included; at eps3 = 0 against the
    port's Kerr to 1e-13 absolute, as JAX's own test holds it;
  * the capture radius (the barrier scan) and the freeze radius are the
    JAX package's floats; initial conditions and extraction as the Kerr
    tests hold them; the plunge exit is off;
  * traces as in test_torch_kerr_newman.py (statuses >= 99.9 %, p99
    |d final_alpha| on stable escaped rays 1e-8 / 2e-3);
  * alpha_crit_traced at reduced iters and azimuths equal to JAX's with
    the same arguments within 1e-12 rad;
  * the renders and CLIs against JAX with both packages' alpha_crit
    replaced by one fixed angle (the bisection is held against JAX
    above; in full it costs ~50 s on the CPU plain loop in every frame,
    while on the card it is the float64 kernel, chip_smoke.py);
  * a JP disk raises ValueError and a charged volumetric scene
    NotImplementedError; the kernel's family check refuses what the
    kernel does not compute.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import aa as jaa
from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu.models import JohannsenPsaltis as JJP
from light_path_tracer_tpu.models.numeric import (
    alpha_crit_traced as j_alpha_crit_traced)
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import aa, disk, pipeline, volumetric
from light_path_tracer_tpu_torch.convert import (metric_from_jax,
                                                 render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman)
from light_path_tracer_tpu_torch.models.numeric import alpha_crit_traced
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
from light_path_tracer_tpu_torch.ops.kerr_trace import trace_rays_kerr
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from test_torch_kerr_newman import (_check_trace, _close, _compare_shadow,
                                    _pair, _screen, _shadow_scene, _state)

R_OBS = 100.0
BAR = {"float64": 1e-12, "float32": 1e-6}
CASES = [(0.9, 2.0), (0.7, 2.5), (0.5, -3.0), (0.0, 5.0)]
# The envelope the renders take on both sides (a = 0.9, eps3 = 2 at
# r_obs = 100 M: 0.0667937501 rad by the full bisection).
ALPHA_CRIT = 0.0668


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def quick_alpha_crit(monkeypatch):
    """Both packages' JohannsenPsaltis.alpha_crit return ALPHA_CRIT (a
    render's pixels do not depend on it: it orders the chunked trace and
    fills the stats)."""
    monkeypatch.setattr(JJP, "alpha_crit",
                        lambda self, *args, **kw: ALPHA_CRIT)
    monkeypatch.setattr(JohannsenPsaltis, "alpha_crit",
                        lambda self, *args, **kw: ALPHA_CRIT)


def _metrics(a, eps3):
    return JJP(M=1.0, a=a, eps3=eps3), JohannsenPsaltis(M=1.0, a=a,
                                                        eps3=eps3)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("a,eps3", CASES)
def test_rhs5_matches_jax_and_its_oracle(a, eps3, dtype):
    jm, tm = _metrics(a, eps3)
    state, p_t, p_phi = _state(512, 0, r_lo=1.05 * tm.capture_radius())
    state[0][:6] = 0.99 * tm._freeze_radius()      # frozen
    j, t = _pair(dtype, *state, p_t, p_phi)
    ref = jm.rhs5(j[:5], j[5], j[6])
    got = tm.rhs5(t[:5], t[5], t[6])
    assert got.shape == (5, 512) and got.dtype == getattr(torch, dtype)
    for c in range(5):
        _close(got[c].numpy(), ref[c], BAR[dtype])
        assert not got[c, :6].any()
    if dtype == "float64":
        oracle = jm.rhs5_autodiff(j[:5], j[5], j[6])
        for c in range(5):
            z = np.asarray(oracle[c])[6:]
            rel = (np.abs(got[c].numpy()[6:] - z)
                   / np.maximum(np.abs(z), 1e-12))
            assert rel.max() < 1e-8


def test_eps3_zero_rhs_matches_kerr():
    state, p_t, p_phi = _state(256, 1)
    _, t = _pair("float64", *state, p_t, p_phi)
    got = JohannsenPsaltis(M=1.0, a=0.7, eps3=0.0).rhs5(t[:5], t[5], t[6])
    ref = Kerr(M=1.0, a=0.7).rhs5(t[:5], t[5], t[6])
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("a,eps3", CASES + [(0.9, 0.0), (0.0, -1000.0)])
def test_host_radii_match_jax(a, eps3):
    jm, tm = _metrics(a, eps3)
    assert tm.capture_radius() == jm.capture_radius()
    assert tm._freeze_radius() == jm._freeze_radius()
    assert tm.r_plus == jm.r_plus
    assert metric_from_jax(jm) == tm
    if eps3 < 0:
        assert tm.capture_radius() > Kerr(M=1.0, a=a).capture_radius()


@pytest.mark.parametrize("theta_obs", [np.pi / 2, 1.1])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_initial_conditions_extraction_and_tdot_match_jax(dtype, theta_obs):
    bar = {"float64": 1e-12, "float32": 1e-5}[dtype]
    jm, tm = _metrics(0.9, 2.0)
    (ja, jt), (ta, tt) = _pair(dtype, *_screen(300, 1))
    jy, _jpt, jpp, _ = jm.initial_conditions_5d(R_OBS, ja, jt, theta_obs)
    ty, _tpt, tpp, tinv = tm.initial_conditions_5d(R_OBS, ta, tt, theta_obs)
    for x, y in zip(ty, jy):
        _close(x.numpy(), np.broadcast_to(np.asarray(y), x.shape), bar)
    _close(tpp.numpy(), jpp, bar)
    assert not tinv.any()
    assert not tm.plunge_radii(R_OBS, ta, tt, theta_obs).any()
    rng = np.random.default_rng(4)
    n = 300
    r = rng.uniform(150.0, 250.0, n)
    r[:20] = 1.45
    captured = np.zeros(n, bool)
    captured[:30] = True
    state = (r, rng.uniform(0.2, 2.9, n), rng.uniform(-20, 20, n),
             rng.uniform(0.2, 1.0, n), rng.uniform(-3, 3, n))
    j, t = _pair(dtype, *state, -np.ones(n), rng.uniform(-6, 6, n))
    js, jfa, jnh = jm.extract_angle(j[:5], j[5], j[6], jnp.asarray(captured))
    ts, tfa, tnh = tm.extract_angle(t[:5], t[5], t[6],
                                    torch.from_numpy(captured))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tnh.numpy(), np.asarray(jnh))
    ok = ~np.isnan(np.asarray(jfa))
    assert ok.sum() > 200
    _close(tfa.numpy()[ok], np.asarray(jfa)[ok], bar)
    _close(tm.tdot(t[:5], t[5], t[6]).numpy(), jm.tdot(j[:5], j[5], j[6]),
           bar)


@pytest.mark.parametrize("dtype,bar", [("float64", 1e-8), ("float32", 2e-3)])
@pytest.mark.parametrize("a,eps3", [(0.9, 2.0), (0.5, -3.0)])
def test_plain_trace_matches_jax(a, eps3, dtype, bar):
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr as jtr
    jm, tm = _metrics(a, eps3)
    ac = 0.05
    al, th = _screen(64, 3, 0.2 * ac, 4.0 * ac)
    (ja, jt), (ta, tt) = _pair(dtype, al, th)
    rj = jtr(jm, R_OBS, ja, jt, np.pi / 2, jnp.zeros(64, bool), 5000.0,
             20000)
    rt = trace_rays_kerr(tm, R_OBS, ta, tt, np.pi / 2,
                         torch.zeros(64, dtype=torch.bool), 5000.0, 20000)
    _check_trace(al, ALPHA_CRIT, rj.status, rj.final_alpha, rt.status.numpy(),
                 rt.final_alpha.numpy(), bar)


def test_plain_trace_matches_pallas_interpret():
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_rays_kerr_pallas)
    jm, tm = _metrics(0.9, 2.0)
    n = 32
    ac = ALPHA_CRIT
    al, th = _screen(n, 2, 0.3 * ac, 4.0 * ac)
    (ja, jt), (ta, tt) = _pair("float32", al, th)
    rp = trace_rays_kerr_pallas(jm, R_OBS, ja, jt, np.pi / 2,
                                jnp.zeros(n, bool), 5000.0, 20000,
                                tile_rows=1, interpret=True)
    rt = trace_rays_kerr(tm, R_OBS, ta, tt, np.pi / 2,
                         torch.zeros(n, dtype=torch.bool), 5000.0, 20000)
    _check_trace(al, ac, rp.status, rp.final_alpha, rt.status.numpy(),
                 rt.final_alpha.numpy(), 2e-3)


@pytest.mark.parametrize("a,eps3,theta_obs", [(0.9, 2.0, np.pi / 2),
                                              (0.5, -3.0, 1.1)])
def test_alpha_crit_traced_matches_jax(a, eps3, theta_obs):
    jm, tm = _metrics(a, eps3)
    kw = dict(n_azimuth=2, iters=6, max_steps=20000)
    got = alpha_crit_traced(tm, R_OBS, theta_obs, device="cpu", **kw)
    ref = j_alpha_crit_traced(jm, R_OBS, theta_obs, **kw)
    assert abs(got - ref) <= 1e-12
    assert 0.5 * ALPHA_CRIT < got < 2.0 * ALPHA_CRIT


def test_alpha_crit_traced_probe_lists_each_trace():
    _, tm = _metrics(0.9, 2.0)
    kw = dict(n_azimuth=2, iters=6, max_steps=20000, device="cpu")
    probe = []
    got = alpha_crit_traced(tm, R_OBS, np.pi / 2, probe=probe, **kw)
    assert got == alpha_crit_traced(tm, R_OBS, np.pi / 2, **kw)
    # The bracket's first test of its upper edge, then one trace an
    # iteration; each entry carries its warp step sum.
    assert len(probe) == 1 + kw["iters"]
    assert all(int(p["n_steps"]) > 0 for p in probe)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_render_shadow_matches_jax(dtype, quick_alpha_crit):
    _compare_shadow(_shadow_scene(a=0.9, eps3=2.0), (32, 32), dtype)


def test_render_scene_and_aa_match_jax(quick_alpha_crit):
    from test_torch_render import checkerboard
    src = checkerboard(16, 24)
    jscene = _shadow_scene(a=0.9, eps3=2.0)
    jcfg = JRender(dtype="float32", backend="xla", sampling="bilinear")
    jout = jpipe.render_scene(jscene, src, jcfg)
    tout = pipeline.render_scene(scene_from_jax(jscene), src,
                                 render_cfg_from_jax(jcfg), device="cpu")
    assert tout.alpha_crit == jout.alpha_crit
    fj = np.asarray(jout.precompute.final_alpha)
    ft = tout.precompute.final_alpha.numpy()
    assert (np.isnan(fj) == np.isnan(ft)).mean() >= 0.99
    wj = np.asarray(jout.precompute.winding).astype(np.int64)
    wt = tout.precompute.winding.to(torch.int32).numpy()
    calm = (wj < 2) & (wt < 2)
    diff = tout.image.numpy()[calm] - np.asarray(jout.image)[calm]
    assert np.sqrt(np.mean(diff ** 2)) < 1e-3
    res = (16, 24)
    img_j, st_j = jaa.render_shadow_aa(jscene, res, JRender(), aa_samples=4)
    img_t, st_t = aa.render_shadow_aa(scene_from_jax(jscene), res,
                                      RenderConfig(), aa_samples=4,
                                      device="cpu")
    assert (img_t.numpy() == np.asarray(img_j)).mean() >= 0.99
    assert ((img_t > 0) & (img_t < 1)).any()
    for key in ("total_rays", "traced_rays", "alpha_crit"):
        assert st_t[key] == st_j[key]


def test_disk_and_charged_volumetric_still_raise():
    """A deformed disk or volumetric scene raises as in the JAX package;
    charged volumetric scenes are ported (held against JAX in
    tests/test_torch_charged_volumetric.py) and render here, at any
    spin."""
    with pytest.raises(ValueError):
        disk.render_disk(SceneConfig(M=1.0, a=0.5, eps3=1.0), (4, 4),
                         device="cpu")
    for scene in (SceneConfig(M=1.0, a=0.5, Q=0.5),
                  SceneConfig(M=1.0, a=0.0, Q=0.5)):
        img, _st = volumetric.render_volumetric(scene, (4, 4), device="cpu")
        layers, _st = volumetric.render_volumetric_decomposed(
            scene, (4, 4), device="cpu")
        assert bool(torch.isfinite(img).all())
        assert bool(torch.isfinite(layers).all())
    with pytest.raises(ValueError):
        volumetric.render_volumetric(SceneConfig(M=1.0, a=0.5, eps3=1.0),
                                     (4, 4), device="cpu")


def test_kernel_family_check():
    """The wrapper names the family by the metric's exact class: the
    shadow kernel takes Kerr, Kerr-Newman and Johannsen-Psaltis, the disk
    variant and the extras kernel the first two; anything else, a
    subclass included, raises before a launch."""
    kn, jp = KerrNewman(M=1.0, a=0.6, Q=0.6), JohannsenPsaltis(M=1.0, a=0.9,
                                                              eps3=2.0)
    assert [kk.metric_family(m) for m in (Kerr(M=1.0, a=0.9), kn, jp)] == \
        [0, 1, 2]
    with pytest.raises(TypeError):
        kk.metric_family(jp, kk.DISK_FAMILIES)
    assert kk.metric_family(kn, kk.EXTRAS_FAMILIES) == 1
    with pytest.raises(TypeError):
        kk.metric_family(jp, kk.EXTRAS_FAMILIES)

    class Other(Kerr):
        pass
    with pytest.raises(TypeError):
        kk.metric_family(Other(M=1.0, a=0.5))
    fs = kk.family_scalars(jp)
    assert fs == dict(family=2, q2=0.0, r_pro=0.0, eps3=2.0,
                      r_freeze=jp._freeze_radius())
    fs = kk.family_scalars(kn)
    assert fs["family"] == 1 and fs["q2"] == 0.36
    assert fs["r_pro"] == kn.unstable_photon_radii()[0]
    # Q = 0 computes Kerr's hot path bitwise: the Kerr instance.
    assert kk.family_scalars(KerrNewman(M=1.0, a=0.6))["family"] == 0


def test_cli_shadow_and_lens_deformed(tmp_path, capsys, quick_alpha_crit):
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png, write_png
    out = tmp_path / "s.png"
    assert main(["shadow", "--a", "0.9", "--eps3", "2", "--size", "24",
                 "--fov-v", "12", "--device", "cpu", "--output",
                 str(out)]) == 0
    assert (f"alpha_crit={np.degrees(ALPHA_CRIT):.4f} deg"
            in capsys.readouterr().out)
    img = read_png(out)
    assert img.shape == (24, 24) and 0 < (img == 0).sum() < img.size
    src = tmp_path / "src.png"
    write_png(src, (np.random.default_rng(0).random((16, 16, 3)) * 255)
              .astype(np.uint8))
    assert main(["lens", "--image", str(src), "--a", "0.9", "--eps3", "2",
                 "--device", "cpu", "--output",
                 str(tmp_path / "l.png")]) == 0
    assert read_png(tmp_path / "l.png").shape == (16, 16, 3)
    with pytest.raises(ValueError):
        main(["shadow", "--a", "0.5", "--Q", "0.3", "--eps3", "1",
              "--size", "8", "--device", "cpu", "--output", str(out)])
