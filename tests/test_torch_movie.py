"""The PyTorch port's flare movie (every observer-time frame in one trace)
against the JAX package.

Inputs come from numpy seeds and go through both packages. Criteria:
  * Kerr.tdot-fed transfer closure on random states, with and without
    absorption and in the pure-geometry mode: float64 within 1e-12 of
    each output's largest value, float32 within 2e-5;
  * trace_rays_spectral over the movie transfer on 192 rays (a = 0.9,
    alpha in [0.3, 4] alpha_crit, theta_obs = 80 deg, max_steps 4000, four
    frames over one blob period, spot_amp 5) against the JAX XLA trace:
    float64 identical statuses, frames within 1e-9 of the largest, t
    within 1e-9 of the largest t; float32 status agreement > 0.99 and p99
    |d frame| / max < 1e-4, p99 |dt| / max t < 1e-4;
  * render_volumetric_movie at 24x24 in float64 against the JAX render
    (frames to 1e-6, emission and light curve to 1e-8 of the largest);
  * physics on the port's CPU path: a stationary flow (spot_amp 0) gives
    identical frames (each within 1e-3 of the still image, whose state
    has fewer components and so other steps), the frames are periodic
    in the blob's period, the light curve varies with the blob, and
    absorption dims every frame;
  * the CUDA wrapper runs the plain loop on CPU tensors and its
    description carries the frame times; the kernel's blob constants are
    Python floats formed in double and rounded once; more than 8 frames
    route to the kernel's broad instances;
  * the `volumetric --movie` command writes one PNG a frame and the
    arrays, and refuses an animated format.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.disk import keplerian_omega as jomega
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
M, A = 1.0, 0.9
PERIOD = 2.0 * np.pi / abs(float(jomega(M, A, 6.0, True)))
TIMES = tuple(PERIOD * k / 4 for k in range(4))
BARS = {"float64": 1e-12, "float32": 2e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _transfers(times=TIMES, **riaf_kw):
    jr = jvol.RIAFConfig(**{"spot_amp": 5.0, **riaf_kw})
    return (jvol.make_movie_transfer(JKerr(M=M, a=A), jr, times),
            volumetric.make_movie_transfer(Kerr(M=M, a=A),
                                           riaf_config_from_jax(jr), times))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("riaf_kw", [
    dict(), dict(alpha0=0.4), dict(g_power=0.0, alpha0=0.2, prograde=False),
    dict(profile="jet", jet_beta=0.5, spot_phase=1.0)],
    ids=["thin", "absorbed", "geometry", "jet"])
def test_movie_closure_matches_jax(riaf_kw, dtype):
    jt, tt = _transfers(**riaf_kw)
    rng = np.random.default_rng(0)
    n = 256
    n_extras = 1 + len(TIMES) + (riaf_kw.get("alpha0", 0.0) > 0)
    y = [rng.uniform(2, 30, n), rng.uniform(0.15, 6.1, n),
         rng.uniform(-9, 9, n), rng.uniform(-1, 1, n), rng.uniform(-3, 3, n),
         rng.uniform(0, 400, n)] + [rng.uniform(0, 3, n)
                                    for _ in range(n_extras - 1)]
    y = [c.astype(dtype) for c in y]
    p_t = -np.ones(n, dtype)
    p_phi = rng.uniform(-4, 4, n).astype(dtype)
    want = jt(tuple(jnp.asarray(c) for c in y), jnp.asarray(p_t),
              jnp.asarray(p_phi))
    got = tt(torch.from_numpy(np.stack(y)), torch.from_numpy(p_t),
             torch.from_numpy(p_phi))
    assert len(got) == len(want) == n_extras
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype
        assert np.abs(g - w).max() <= BARS[dtype] * np.abs(w).max()
    assert tt.kernel.kind == "movie" and tt.kernel.times == TIMES


def _rays(n, seed, dtype):
    ac = JKerr(M=M, a=A).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3 * ac, 4 * ac, n).astype(dtype),
            rng.uniform(-np.pi, np.pi, n).astype(dtype))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_movie_trace_matches_jax(dtype):
    al, th = _rays(192, 1, dtype)
    jt, tt = _transfers(alpha0=0.3)
    n_bands = 1 + len(TIMES)
    monitor = tuple(range(2, 2 + len(TIMES)))
    rj = jspec(JKerr(M=M, a=A), R_OBS, jnp.asarray(al), jnp.asarray(th),
               THETA, jt, n_bands, 5000.0, 4000, sat_window=512,
               sat_monitor=monitor)
    rt = tk.trace_rays_spectral(
        Kerr(M=M, a=A), R_OBS, torch.from_numpy(al), torch.from_numpy(th),
        THETA, tt, n_bands, 5000.0, 4000, sat_window=512,
        sat_monitor=monitor)
    sj, st = _np(rj.status), _np(rt.status)
    pairs = [(_np(rj.tau_hat), _np(rt.tau_hat))] + [
        (_np(a), _np(b)) for a, b in zip(rj.emission, rt.emission)]
    assert len(pairs) == 2 + len(TIMES)
    assert (pairs[2][1] > 0).sum() > 10
    if dtype == "float64":
        np.testing.assert_array_equal(st, sj)
        for a, b in pairs:
            assert np.abs(a - b).max() < 1e-9 * np.abs(a).max()
        return
    ok = sj == st
    assert ok.mean() > 0.99
    for a, b in pairs:
        assert np.percentile(np.abs(a - b)[ok], 99) < 1e-4 * np.abs(a).max()


def test_render_movie_matches_jax():
    jscene = JScene(M=M, a=A, r_obs_mult=R_OBS, vertical_fov_deg=16.0,
                    theta_obs=THETA)
    jcfg = JRender(dtype="float64", backend="xla")
    jr = jvol.RIAFConfig(spot_amp=6.0, alpha0=0.2)
    jf, jst = jvol.render_volumetric_movie(jscene, (24, 24), TIMES, jcfg, jr)
    tf, tst = volumetric.render_volumetric_movie(
        scene_from_jax(jscene), (24, 24), TIMES, render_cfg_from_jax(jcfg),
        riaf_config_from_jax(jr), device="cpu")
    assert tf.dtype == torch.float32 and tf.shape == (4, 24, 24)
    assert set(tst) == set(jst)
    assert np.abs(tf.numpy() - np.asarray(jf)).max() < 1e-6
    em = jst["emission"]
    assert np.abs(tst["emission"] - em).max() < 1e-8 * em.max()
    np.testing.assert_allclose(tst["light_curve"], jst["light_curve"],
                               rtol=1e-8)
    np.testing.assert_allclose(tst["optical_depth"], jst["optical_depth"],
                               atol=1e-8 * jst["optical_depth"].max())
    np.testing.assert_allclose(tst["t_max"], jst["t_max"], rtol=1e-9)
    np.testing.assert_allclose(tst["spot_period"], jst["spot_period"],
                               rtol=1e-14)
    for key in ("captured", "invalid", "total_rays", "traced_rays"):
        assert tst[key] == jst[key]


def test_movie_frames_are_periodic_and_follow_the_blob():
    scene = SceneConfig(M=M, a=A, theta_obs=THETA, vertical_fov_deg=16.0)
    cfg = RenderConfig(max_steps=20000)
    size = (24, 24)
    still = volumetric.RIAFConfig(spot_amp=0.0)
    frames, st = volumetric.render_volumetric_movie(
        scene, size, (0.0, 31.0, 77.0), cfg, still, device="cpu")
    assert torch.equal(frames[0], frames[1])
    assert torch.equal(frames[0], frames[2])
    flat = st["light_curve"]
    assert np.ptp(flat) == 0.0
    image, _ = volumetric.render_volumetric(scene, size, cfg, still,
                                            device="cpu")
    # the movie's state carries t and three frames, so its error norm
    # and with it the step sequence differ from the still image's
    assert float((frames[0] - image).abs().max()) < 1e-3
    blob = volumetric.RIAFConfig(spot_amp=8.0)
    times = (0.0, 0.25 * PERIOD, 0.5 * PERIOD, PERIOD)
    frames, st = volumetric.render_volumetric_movie(scene, size, times, cfg,
                                                    blob, device="cpu")
    assert abs(st["spot_period"] - PERIOD) < 1e-9 * PERIOD
    em, lc = st["emission"], st["light_curve"]
    assert np.abs(em[3] - em[0]).max() < 2e-3 * em.max()      # one period
    assert np.abs(em[2] - em[0]).max() > 0.05 * em.max()
    assert (lc.max() - lc.min()) / (lc.max() + lc.min()) > 0.02
    assert float(frames.max()) == 1.0 and st["t_max"] > 2 * R_OBS
    _f, sa = volumetric.render_volumetric_movie(
        scene, size, times, cfg,
        volumetric.RIAFConfig(spot_amp=8.0, alpha0=0.3), device="cpu")
    assert (sa["light_curve"] < lc).all() and sa["optical_depth"].max() > 0.1
    assert st["optical_depth"].max() == 0.0


def test_movie_wrapper_on_cpu_and_kernel_constants():
    _jt, tt = _transfers()
    al, th = _rays(32, 2, np.float32)
    m = Kerr(M=M, a=A)
    args = (m, R_OBS, torch.from_numpy(al), torch.from_numpy(th), THETA)
    launches = vk.trace_rays_aux_cuda.launches
    got = vk.trace_rays_spectral_cuda(*args, tt, 4, 5000.0, 2000,
                                      sat_monitor=(1, 2, 3, 4))
    want = tk.trace_rays_spectral(*args, tt, 4, 5000.0, 2000,
                                  sat_monitor=(1, 2, 3, 4))
    assert vk.trace_rays_aux_cuda.launches == launches
    for x, y in zip(got.emission + (got.tau_hat,),
                    want.emission + (want.tau_hat,)):
        assert torch.equal(x, y)
    riaf = volumetric.RIAFConfig(spot_amp=3.5, spot_r=7.0, spot_sigma=1.3,
                                 spot_phase=0.4, prograde=False, alpha0=0.2)
    m2 = Kerr(M=2.0, a=0.6)
    spec = volumetric.make_movie_transfer(m2, riaf, (1.0, 2.5)).kernel
    p = vk.riaf_params(spec)
    f32 = np.float32
    assert p.spot_amp == f32(3.5) and p.spot_phase == f32(0.4)
    assert p.spot_r == 7.0 and p.spot_r2 == 49.0
    assert p.two_spot_sig2 == f32(2.0 * 1.3 ** 2)
    assert p.spot_omega == f32(float(jomega(2.0, 0.6, 7.0, False)))
    assert list(p.times)[:3] == [1.0, 2.5, 0.0]
    assert vk._family(spec, 4, 0) == ("lpt_kerr_dp45_movie_absorbed", 1, 2)
    thin = volumetric.make_movie_transfer(m2, volumetric.RIAFConfig(),
                                          tuple(range(8))).kernel
    assert vk._family(thin, 9, 0) == ("lpt_kerr_dp45_movie_thin", 0, 8)
    nine = volumetric.make_movie_transfer(m2, volumetric.RIAFConfig(),
                                          tuple(range(9))).kernel
    assert vk._family(nine, 10, 0) == (vk.BROAD_ENTRY, 1, 9)
    with pytest.raises(ValueError, match="spot_amp"):
        volumetric.make_movie_transfer(
            m2, volumetric.RIAFConfig(spot_amp=-1.0), (0.0,))
    with pytest.raises(ValueError, match="times"):
        volumetric.make_movie_transfer(m2, volumetric.RIAFConfig(), ())
    with pytest.raises(NotImplementedError):
        volumetric.render_volumetric_movie(
            SceneConfig(M=M, a=A), (4, 4), (0.0,), mesh=object(),
            device="cpu")


def test_cli_movie_on_cpu(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png
    common = ["volumetric", "--size", "16", "--a", "0.9", "--theta-obs",
              "80", "--fov-v", "16", "--device", "cpu"]
    out = tmp_path / "m.png"
    assert main(common + ["--movie", "3", "--spot-amp", "8", "--output",
                          str(out)]) == 0
    text = capsys.readouterr().out
    assert "Flare movie: 3 frames (1.0 orbit(s), period 98.0 M)" in text
    assert "light curve modulation" in text
    for k in range(3):
        assert read_png(tmp_path / f"m_{k:03d}.png").shape == (16, 16, 3)
    data = np.load(tmp_path / "m_movie.npz")
    assert set(data.files) == {"times", "light_curve", "emission"}
    assert data["emission"].shape == (3, 16, 16)
    assert np.ptp(data["light_curve"]) > 0.0
    with pytest.raises(ValueError, match="PNG"):
        main(common + ["--movie", "3", "--output", str(tmp_path / "m.gif")])
    # --centroid is ported: the track's CSV columns beside the name.
    assert main(common + ["--movie", "3", "--centroid",
                          str(tmp_path / "c.png"), "--output", str(out)]) == 0
    track = np.loadtxt(tmp_path / "c.csv", delimiter=",")
    assert track.shape == (3, 4) and np.isfinite(track).all()
