"""The port's Kerr-Newman family against the JAX package's.

The same inputs, made with numpy from a seed, go through both packages;
JAX runs its XLA branch (or its Pallas kernel in interpret mode), the
port its plain loops on the CPU. Criteria:
  * rhs5 against JAX's hand form and its jax.grad oracle at (a, Q)
    corners: float64 within 1e-12 of each component's largest magnitude
    (the oracle at JAX's own bar, 2e-12 relative plus 1e-12), float32
    within 1e-6 of it (16 ulp of the quotients' rounding);
  * at Q = 0 every batched method is the port's Kerr's, bitwise, and so
    is the plain trace;
  * initial conditions, plunge radii and extraction as the Kerr tests
    hold them (float64 1e-12, float32 1e-5 of the largest magnitude);
    host geometry (r_+, capture radius, photon-orbit band, alpha_crit,
    impact parameter) equal floats;
  * traces: statuses agree on >= 99.9 %, and on escaped rays away from
    the critical curve (|alpha - alpha_crit| > 0.05 alpha_crit) the 99th
    percentile of |d final_alpha| is below 1e-8 in float64 and 2e-3 in
    float32 (the packages' float32 sin and cos differ by an ulp);
  * at a = 0 the 5-D trace against the Reissner-Nordstrom orbit path,
    median |d alpha| < 2e-4 (two integrators), as the JAX test holds it;
  * the renders at 32x32 to 48x48 and the CLIs.
The CUDA kernel against these loops runs on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import aa as jaa
from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu.models import KerrNewman as JKN
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr as jtrace
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import aa, camera, disk, pipeline
from light_path_tracer_tpu_torch.convert import (disk_config_from_jax,
                                                 metric_from_jax,
                                                 render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import (Kerr, KerrNewman,
                                                ReissnerNordstrom)
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.ops.kerr_trace import trace_rays_kerr

R_OBS = 100.0
BAR = {"float64": 1e-12, "float32": 1e-6}
CORNERS = [(0.9, 0.0), (0.6, 0.5), (0.0, 0.8), (0.3, 0.9), (0.6, 0.6),
           (-0.5, 0.4)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, bar):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=bar * scale)


def _pair(dtype, *arrays):
    """numpy float64 arrays -> (jax arrays, torch CPU tensors) in dtype."""
    j = tuple(jnp.asarray(np.asarray(a, np.dtype(dtype))) for a in arrays)
    t = tuple(torch.from_numpy(np.asarray(a, np.dtype(dtype)))
              for a in arrays)
    return j, t


def _state(n, seed, r_lo=2.5):
    rng = np.random.default_rng(seed)
    return ((rng.uniform(r_lo, 80.0, n), rng.uniform(0.2, np.pi - 0.2, n),
             rng.uniform(-np.pi, np.pi, n), rng.uniform(-1.0, 1.0, n),
             rng.uniform(-6.0, 6.0, n)),
            -np.ones(n), rng.uniform(-6.0, 6.0, n))


def _screen(n, seed, lo=0.005, hi=0.3):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, n), rng.uniform(-np.pi, np.pi, n)


def _rhs_pair(jm, tm, dtype, state, p_t, p_phi):
    j, t = _pair(dtype, *state, p_t, p_phi)
    return jm.rhs5(j[:5], j[5], j[6]), tm.rhs5(t[:5], t[5], t[6]), j


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("a,q", CORNERS)
def test_rhs5_matches_jax_and_its_oracle(a, q, dtype):
    state, p_t, p_phi = _state(256, 7)
    state[0][:6] = 1.0005 * KerrNewman(M=1.0, a=a, Q=q).r_plus  # frozen
    jm, tm = JKN(M=1.0, a=a, Q=q), KerrNewman(M=1.0, a=a, Q=q)
    ref, got, j = _rhs_pair(jm, tm, dtype, state, p_t, p_phi)
    assert got.shape == (5, 256) and got.dtype == getattr(torch, dtype)
    for c in range(5):
        _close(got[c].numpy(), ref[c], BAR[dtype])
        assert not got[c, :6].any()
    if dtype == "float64":
        oracle = jm.rhs5_autodiff(j[:5], j[5], j[6])
        for c in range(5):
            np.testing.assert_allclose(got[c].numpy(),
                                       np.asarray(oracle[c]),
                                       rtol=2e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_q0_is_kerr_bitwise(dtype):
    """Q = 0: the RHS takes Kerr's branch (as JAX's static one does), and
    the initial conditions, plunge radii, extraction, tdot and the plain
    trace are the port's Kerr's, bitwise."""
    kn, k = KerrNewman(M=1.0, a=0.9, Q=0.0), Kerr(M=1.0, a=0.9)
    state, p_t, p_phi = _state(256, 5)
    _, t = _pair(dtype, *state, p_t, p_phi)
    assert torch.equal(kn.rhs5(t[:5], t[5], t[6]), k.rhs5(t[:5], t[5], t[6]))
    assert torch.equal(kn.tdot(t[:5], t[5], t[6]), k.tdot(t[:5], t[5], t[6]))
    _, (al, th) = _pair(dtype, *_screen(128, 6, 0.02, 0.12))
    for x, y in zip(kn.initial_conditions_5d(R_OBS, al, th, 1.2),
                    k.initial_conditions_5d(R_OBS, al, th, 1.2)):
        for u, v in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)
    assert torch.equal(kn.plunge_radii(R_OBS, al, th, 1.2),
                       k.plunge_radii(R_OBS, al, th, 1.2))
    captured = torch.arange(256) % 9 == 0
    for u, v in zip(kn.extract_angle(t[:5], t[5], t[6], captured),
                    k.extract_angle(t[:5], t[5], t[6], captured)):
        assert torch.equal(u.nan_to_num(7.0), v.nan_to_num(7.0))
    refine = torch.zeros(128, dtype=torch.bool)
    r_kn = trace_rays_kerr(kn, R_OBS, al, th, np.pi / 2, refine, 5000.0,
                           5000)
    r_k = trace_rays_kerr(k, R_OBS, al, th, np.pi / 2, refine, 5000.0, 5000)
    for u, v in zip(r_kn, r_k):
        assert torch.equal(u.nan_to_num(7.0), v.nan_to_num(7.0))


@pytest.mark.parametrize("theta_obs", [np.pi / 2, 1.1])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_initial_conditions_and_plunge_match_jax(dtype, theta_obs):
    bar = {"float64": 1e-12, "float32": 1e-5}[dtype]
    jm, tm = JKN(M=1.0, a=0.6, Q=0.6), KerrNewman(M=1.0, a=0.6, Q=0.6)
    (ja, jt), (ta, tt) = _pair(dtype, *_screen(300, 1))
    jy, jpt, jpp, jinv = jm.initial_conditions_5d(R_OBS, ja, jt, theta_obs)
    ty, tpt, tpp, tinv = tm.initial_conditions_5d(R_OBS, ta, tt, theta_obs)
    for a, b in zip(ty, jy):
        _close(a.numpy(), np.broadcast_to(np.asarray(b), a.shape), bar)
    _close(tpp.numpy(), jpp, bar)
    assert not tinv.any() and not np.asarray(jinv).any()
    ref = np.asarray(jm.plunge_radii(R_OBS, ja, jt, theta_obs))
    got = tm.plunge_radii(R_OBS, ta, tt, theta_obs).numpy()
    np.testing.assert_array_equal(got == 0.0, ref == 0.0)
    _close(got, ref, bar)
    assert (ref > 0).any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_extract_angle_and_tdot_match_jax(dtype):
    bar = {"float64": 1e-12, "float32": 1e-5}[dtype]
    jm, tm = JKN(M=1.0, a=0.6, Q=0.6), KerrNewman(M=1.0, a=0.6, Q=0.6)
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
    np.testing.assert_array_equal(np.isnan(tfa.numpy()), ~ok)
    assert ok.sum() > 200
    _close(tfa.numpy()[ok], np.asarray(jfa)[ok], bar)
    _close(tm.tdot(t[:5], t[5], t[6]).numpy(), jm.tdot(j[:5], j[5], j[6]),
           bar)


@pytest.mark.parametrize("a,q", CORNERS + [(0.6, 0.8), (0.0, 1.0)])
def test_host_geometry_matches_jax(a, q):
    jm, tm = JKN(M=1.0, a=a, Q=q), KerrNewman(M=1.0, a=a, Q=q)
    assert tm.r_plus == jm.r_plus
    assert tm.capture_radius() == jm.capture_radius()
    assert tm.unstable_photon_radii() == jm.unstable_photon_radii()
    for theta_obs in (np.pi / 2, 1.1):
        assert tm.alpha_crit(R_OBS, theta_obs) == jm.alpha_crit(
            R_OBS, theta_obs)
    assert tm.viewing_angle_to_impact_parameter(0.03, R_OBS, 1.1) == \
        jm.viewing_angle_to_impact_parameter(0.03, R_OBS, 1.1)
    assert metric_from_jax(jm) == tm
    with pytest.raises(ValueError):
        KerrNewman(M=1.0, a=0.8, Q=0.7)


def _trace_pair(jm, tm, dtype, n, seed, max_steps=20000):
    ac = tm.alpha_crit(R_OBS)
    al, th = _screen(n, seed, 0.2 * ac, 4.0 * ac)
    (ja, jt), (ta, tt) = _pair(dtype, al, th)
    rj = jtrace(jm, R_OBS, ja, jt, np.pi / 2, jnp.zeros(n, bool), 5000.0,
                max_steps)
    rt = trace_rays_kerr(tm, R_OBS, ta, tt, np.pi / 2,
                         torch.zeros(n, dtype=torch.bool), 5000.0, max_steps)
    return al, ac, rj, rt


def _check_trace(al, ac, status_j, fa_j, status_t, fa_t, bar):
    status_j, status_t = np.asarray(status_j), np.asarray(status_t)
    assert (status_j == status_t).mean() >= 0.999
    stable = ((status_j == 1) & (status_t == 1)
              & (np.abs(al - ac) > 0.05 * ac))
    assert stable.sum() >= 0.4 * len(al)
    d = np.abs(np.asarray(fa_j)[stable] - np.asarray(fa_t)[stable])
    assert np.percentile(d, 99) < bar
    assert (status_t == -1).any()


@pytest.mark.parametrize("dtype,bar", [("float64", 1e-8), ("float32", 2e-3)])
def test_plain_trace_matches_jax(dtype, bar):
    jm, tm = JKN(M=1.0, a=0.6, Q=0.6), KerrNewman(M=1.0, a=0.6, Q=0.6)
    al, ac, rj, rt = _trace_pair(jm, tm, dtype, 128, 3)
    _check_trace(al, ac, rj.status, rj.final_alpha, rt.status.numpy(),
                 rt.final_alpha.numpy(), bar)
    assert int(rt.n_steps) > 0


def test_plain_trace_matches_pallas_interpret():
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_rays_kerr_pallas)
    jm, tm = JKN(M=1.0, a=0.6, Q=0.6), KerrNewman(M=1.0, a=0.6, Q=0.6)
    n = 32
    ac = tm.alpha_crit(R_OBS)
    al, th = _screen(n, 9, 0.3 * ac, 4.0 * ac)
    (ja, jt), (ta, tt) = _pair("float32", al, th)
    rp = trace_rays_kerr_pallas(jm, R_OBS, ja, jt, np.pi / 2,
                                jnp.zeros(n, bool), 5000.0, 5000,
                                tile_rows=1, interpret=True)
    rt = trace_rays_kerr(tm, R_OBS, ta, tt, np.pi / 2,
                         torch.zeros(n, dtype=torch.bool), 5000.0, 5000)
    _check_trace(al, ac, rp.status, rp.final_alpha, rt.status.numpy(),
                 rt.final_alpha.numpy(), 2e-3)


def test_a_zero_matches_reissner_nordstrom_orbit_path():
    kn = KerrNewman(M=1.0, a=0.0, Q=0.8)
    rn = ReissnerNordstrom(M=1.0, Q=0.8)
    assert kn.alpha_crit(R_OBS) == pytest.approx(rn.alpha_crit(R_OBS),
                                                 rel=1e-10)
    alphas = torch.tensor(np.linspace(1.2, 3.0, 9) * rn.alpha_crit(R_OBS),
                          dtype=torch.float64)
    res_kn = trace_batch(kn, R_OBS, alphas, torch.full_like(alphas,
                                                            np.pi / 2))
    res_rn = trace_batch(rn, R_OBS, alphas)
    ok = (res_kn.status == 1) & (res_rn.status == 1)
    assert int(ok.sum()) >= 7
    d = (res_kn.final_alpha[ok] - res_rn.final_alpha[ok]).abs()
    assert float(d.median()) < 2e-4
    assert torch.equal(res_kn.n_half_orbits[ok], res_rn.n_half_orbits[ok])


def _shadow_scene(**kw):
    return JScene(M=1.0, r_obs_mult=R_OBS, vertical_fov_deg=12.0, **kw)


def _compare_shadow(jscene, dim, dtype, chunk_size=None):
    """render_shadow on both sides: equal stats, shadow masks equal on
    >= 99 % of pixels, final angles as _check_trace holds them."""
    jcfg = JRender(dtype=dtype, backend="xla", chunk_size=chunk_size)
    scene, cfg = scene_from_jax(jscene), render_cfg_from_jax(jcfg)
    jimg, jst = jpipe.render_shadow(jscene, dim, jcfg)
    timg, tst = pipeline.render_shadow(scene, dim, cfg, device="cpu")
    for key in ("traced_rays", "total_rays", "alpha_crit"):
        assert tst[key] == jst[key]
    jmask, tmask = np.asarray(jimg) == 0.0, timg.numpy() == 0.0
    assert (jmask == tmask).mean() >= 0.99
    assert 0.05 < tmask.mean() < 0.95
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    jpre = jpipe.precompute_final_alpha(jscene, jcfg, dim, fov)
    tpre = pipeline.precompute_final_alpha(scene, cfg, dim, fov,
                                           device="cpu")
    alpha = camera.build_alpha_lookup(dim, fov, dtype=torch.float64,
                                      device="cpu").numpy().reshape(-1)
    fj = np.asarray(jpre.final_alpha).reshape(-1)
    ft = tpre.final_alpha.numpy().reshape(-1)
    status = (lambda f: np.where(np.isnan(f), -1, 1))
    _check_trace(alpha, tst["alpha_crit"], status(fj), fj, status(ft), ft,
                 1e-8 if dtype == "float64" else 1e-3)
    return timg, tst


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_render_shadow_matches_jax(dtype):
    timg, _ = _compare_shadow(_shadow_scene(a=0.6, Q=0.6), (32, 32), dtype)
    # The charged shadow lies inside the same-spin Kerr shadow.
    kimg, _ = pipeline.render_shadow(
        scene_from_jax(_shadow_scene(a=0.6)), (32, 32),
        render_cfg_from_jax(JRender(dtype=dtype)), device="cpu")
    dark, dark_k = timg.numpy() == 0.0, kimg.numpy() == 0.0
    assert 0 < dark.sum() < dark_k.sum()
    assert not (dark & ~dark_k).any()


def test_render_shadow_chunked_sorted_matches_jax():
    _compare_shadow(_shadow_scene(a=0.6, Q=0.6), (24, 32), "float32",
                    chunk_size=160)


def test_render_scene_matches_jax():
    from test_torch_render import checkerboard
    dim = (32, 32)
    src = checkerboard(*dim)
    jscene = _shadow_scene(a=0.6, Q=0.6)
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
    img = tout.image.numpy()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert (img[np.isnan(ft)] == 0.0).all()
    diff = img[calm] - np.asarray(jout.image)[calm]
    assert np.sqrt(np.mean(diff ** 2)) < 1e-3


def test_render_shadow_aa_matches_jax():
    res = (24, 32)
    jscene = JScene(M=1.0, a=0.6, Q=0.6)
    img_j, st_j = jaa.render_shadow_aa(jscene, res, JRender(), aa_samples=4)
    img_t, st_t = aa.render_shadow_aa(scene_from_jax(jscene), res,
                                      render_cfg_from_jax(JRender()),
                                      aa_samples=4, device="cpu")
    img_t = img_t.numpy()
    assert (img_t == np.asarray(img_j)).mean() >= 0.99
    assert ((img_t > 0) & (img_t < 1)).any()
    for key in ("total_rays", "traced_rays", "alpha_crit"):
        assert st_t[key] == st_j[key]


@pytest.mark.parametrize("a,q", [(0.6, 0.6), (0.0, 0.8)])
def test_render_disk_matches_jax(a, q):
    """The charged thin disk (config 4's scene, charged; a = 0 is
    Kerr-Newman too): float64 renders with equal disk and capture
    counts and images within 1e-6."""
    jscene = JScene(M=1.0, a=a, Q=q, r_obs_mult=R_OBS,
                    vertical_fov_deg=30.0, theta_obs=float(np.radians(80.0)))
    jcfg = JRender(dtype="float64", backend="xla")
    jd = jdisk.DiskConfig()
    assert type(jdisk._scene_metric(jscene)).__name__ == "KerrNewman"
    assert type(disk._scene_metric(scene_from_jax(jscene))) is KerrNewman
    dim = (32, 32)
    jimg, jst = jdisk.render_disk(jscene, dim, jcfg, jd)
    timg, tst = disk.render_disk(scene_from_jax(jscene), dim,
                                 render_cfg_from_jax(jcfg),
                                 disk_config_from_jax(jd), device="cpu")
    for key in ("alpha_crit", "r_isco", "total_rays", "disk_pixels",
                "captured"):
        assert tst[key] == jst[key]
    assert tst["disk_pixels"] > 50
    assert np.abs(timg.numpy() - np.asarray(jimg)).max() < 1e-6
    # The charged ISCO sits inside the uncharged one.
    assert tst["r_isco"] < disk.r_isco(1.0, a)


def test_charged_helpers_match_jax():
    import light_path_tracer_tpu.disk as jd
    r = torch.linspace(2.5, 20.0, 64, dtype=torch.float64)
    c = torch.linspace(-0.9, 0.9, 64, dtype=torch.float64)
    for prograde in (True, False):
        got = disk.keplerian_redshift(1.0, 0.6, r, 2.0 * c, prograde, Q=0.6)
        ref = jd.keplerian_redshift(1.0, 0.6, jnp.asarray(r.numpy()),
                                    jnp.asarray(2.0 * c.numpy()), prograde,
                                    Q=0.6)
        _close(got.numpy(), ref, 1e-14)
    got = disk.covariant_tphi_components(KerrNewman(1.0, 0.6, 0.6), r, c)
    ref = jd.covariant_tphi_components(JKN(1.0, 0.6, 0.6),
                                       jnp.asarray(r.numpy()),
                                       jnp.asarray(c.numpy()))
    for x, y in zip(got, ref):
        _close(x.numpy(), y, 1e-14)


def test_cli_shadow_and_lens_charged(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png, write_png
    out = tmp_path / "s.png"
    assert main(["shadow", "--a", "0.6", "--Q", "0.6", "--size", "24",
                 "--fov-v", "12", "--device", "cpu", "--output",
                 str(out)]) == 0
    ac = KerrNewman(M=1.0, a=0.6, Q=0.6).alpha_crit(R_OBS, np.pi / 2)
    assert f"alpha_crit={np.degrees(ac):.4f} deg" in capsys.readouterr().out
    img = read_png(out)
    assert img.shape == (24, 24) and 0 < (img == 0).sum() < img.size
    src = tmp_path / "src.png"
    write_png(src, (np.random.default_rng(0).random((16, 16, 3)) * 255)
              .astype(np.uint8))
    assert main(["lens", "--image", str(src), "--a", "0.6", "--Q", "0.6",
                 "--device", "cpu", "--output",
                 str(tmp_path / "l.png")]) == 0
    assert "alpha_crit = " in capsys.readouterr().out
    assert read_png(tmp_path / "l.png").shape == (16, 16, 3)
