"""The port's spectra, flare movies and order decompositions wider than
the CUDA extras kernel's compiled instances (more than 8 bands or frames,
more than 4 orders) against the JAX package, and the wrapper's route to
the broad instances (csrc/kerr_broad_extras.cuh).

Inputs come from numpy seeds and go through both packages on the CPU,
where the CUDA wrapper runs its plain loop (ops/kerr_trace.py
trace_rays_spectral). Criteria, as tests/test_torch_movie.py's:
  * 192 rays (a = 0.9, alpha in [0.3, 4] alpha_crit, theta_obs = 80 deg,
    max_steps 4000) through a 12-frame movie, thin and absorbed, and a
    10-band self-absorbed spectrum; 32 rays through a 33-band one with the
    saturation exit on (sat_window 64, every band monitored: more extras
    than the narrow kernel's 32-bit monitor holds). float64: identical
    statuses and every extra within 1e-9 of its largest value. float32:
    status agreement > 0.99, and each extra held against JAX's float64
    trace of the same rays: p99 |port - JAX float32| < 1e-3 of the
    largest value, and the port's own float32 error (p99 |port - JAX
    float64|) at most twice JAX's plus 1e-4. The narrow widths' 1e-4
    bar between the two float32 results is below float32's own error
    here: scripts/torch_f32_gap.py over eight seeds read each package's
    float32 error 1.1e-4 to 2.4e-3 of the largest value, the gap between
    the packages 3.3e-6 to 5.6e-4, and the same gap 2.7e-5 to 2.8e-4 at
    tests/test_torch_movie.py's own 4 frames (its seed reads 2.7e-5; two
    of the eight seeds read above 1e-4);
  * 5 and 6 orders in float64 on 192 rays just outside the critical
    curve of a = 0 (alpha_crit (1 + eps), eps log-uniform in [1e-7,
    1e-1], a power-law emitter, so every order has carriers): identical
    statuses; the winding m within 1e-9 of its largest value on the
    median ray and 1e-4 on every ray (read: median 7e-14 to 1e-13, 17-21
    rays above 1e-9, the largest 1.3e-6 and 6.0e-6: a winding ray's steps
    straddle the buckets' edges, where the integrand switches and the
    step control reads rounding); and the buckets held by
    chip_smoke.order_gate's flux rule (bucket edges split rays between
    neighbouring orders on rounding);
  * 5 and 6 orders in float32 on 192 rays away from the critical curve
    (eps log-uniform in [1e-3, 1], where the statuses agree): identical
    statuses, the winding m within 1e-3 of its largest value on the
    median ray, the per-ray sum of the buckets held as the float32
    extras are (the port's float32 error at most twice JAX's plus 1e-4)
    the flux moved between orders within order_gate's bar, and orders 0
    and 1 within its per-order flux bars. Order 2 and above are not held
    to those bars: in float32 the two packages round m after each
    crossing independently, so each ray's stretch of path falls in
    either neighbouring bucket on its own coin. scripts/torch_f32_gap.py
    over eight seeds read orders 0 and 1 0.1 % to 13.5 % apart (bars 22 %
    to 26 %), order 2 0.1 % to 48 % (bars 32 % to 36 %). The card holds
    the float32 order forms against the port's own plain loop, bitwise
    or by the full gate (chip_smoke.py phase 26);
  * the route: above the narrow widths `_family` picks the broad entry
    with the width as its variant, its per-width constants are formed in
    double and rounded once, and the monitor words hold every extra.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_spectral as jspec
from light_path_tracer_tpu_torch import volumetric
from light_path_tracer_tpu_torch.convert import riaf_config_from_jax
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk

R_OBS = 100.0
THETA = float(np.radians(80.0))
M, A = 1.0, 0.9
TIMES12 = tuple(98.0 * k / 12 for k in range(12))
FREQS10 = tuple(float(f) for f in np.geomspace(0.3, 3.0, 10))
FREQS33 = tuple(float(f) for f in np.geomspace(0.2, 5.0, 33))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rays(n, seed, dtype):
    ac = JKerr(M=M, a=A).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3 * ac, 4 * ac, n).astype(dtype),
            rng.uniform(-np.pi, np.pi, n).astype(dtype))


def _transfer(kind, a, width, **riaf_kw):
    """(JAX transfer, port transfer, bands) of a wide transfer."""
    jr = jvol.RIAFConfig(**riaf_kw)
    tr = riaf_config_from_jax(jr)
    if kind == "movie":
        times = TIMES12[:width]
        return (jvol.make_movie_transfer(JKerr(M=M, a=a), jr, times),
                volumetric.make_movie_transfer(Kerr(M=M, a=a), tr, times),
                width + (jr.alpha0 > 0.0))
    if kind == "spectral":
        freqs = FREQS10 if width == 10 else FREQS33
        return (jvol.make_spectral_transfer(JKerr(M=M, a=a), jr, freqs),
                volumetric.make_spectral_transfer(Kerr(M=M, a=a), tr, freqs),
                width)
    return (jvol.make_order_transfer(JKerr(M=M, a=a), jr, width),
            volumetric.make_order_transfer(Kerr(M=M, a=a), tr, width),
            width + (jr.alpha0 > 0.0))


def _both(a, al, th, jt, tt, n_bands, **kw):
    rj = jspec(JKerr(M=M, a=a), R_OBS, jnp.asarray(al), jnp.asarray(th),
               THETA, jt, n_bands, 5000.0, 4000, **kw)
    rt = tk.trace_rays_spectral(
        Kerr(M=M, a=a), R_OBS, torch.from_numpy(al), torch.from_numpy(th),
        THETA, tt, n_bands, 5000.0, 4000, **kw)
    pairs = [(_np(rj.tau_hat), _np(rt.tau_hat))] + [
        (_np(x), _np(y)) for x, y in zip(rj.emission, rt.emission)]
    return _np(rj.status), _np(rt.status), pairs


def _jax64(a, al, th, jt, n_bands, **kw):
    """JAX's float64 trace of float32 rays: (statuses, [extras])."""
    r = jspec(JKerr(M=M, a=a), R_OBS, jnp.asarray(al, dtype=jnp.float64),
              jnp.asarray(th, dtype=jnp.float64), THETA, jt, n_bands,
              5000.0, 4000, **kw)
    return _np(r.status), [_np(r.tau_hat)] + [_np(e) for e in r.emission]


def f32_readings(sj, st, s64, pairs, ref):
    """The float32 numbers of a case: (JAX, port) float32 extras `pairs`
    against JAX's float64 extras `ref`, as p99 over the rays whose three
    statuses agree divided by the largest float64 value: the worst
    extra's gap between the packages and each package's error, and the
    largest (port error - 2 JAX error) over the extras."""
    ok = (sj == st) & (s64 == sj)
    rows = []
    for (a, b), r in zip(pairs, ref):
        top = np.abs(r).max()
        rows.append([np.percentile(np.abs(x)[ok], 99) / top
                     for x in (a - b, b - r, a - r)])
    rows = np.asarray(rows)
    return dict(status_agree=float((sj == st).mean()),
                gap=float(rows[:, 0].max()), port=float(rows[:, 1].max()),
                jax=float(rows[:, 2].max()),
                excess=float((rows[:, 1] - 2.0 * rows[:, 2]).max()))


F32_CASES = {
    "movie12-thin": ("movie", 12, 192, dict(spot_amp=5.0), {}),
    "movie12-absorbed": ("movie", 12, 192, dict(spot_amp=5.0, alpha0=0.3),
                         {}),
    "spectral10": ("spectral", 10, 192, dict(alpha0=0.3), {}),
    "spectral33-saturation": ("spectral", 33, 32, dict(alpha0=0.3),
                              dict(sat_window=64))}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(F32_CASES))
def test_wide_plain_trace_matches_jax(name, dtype):
    kind, width, n, riaf_kw, kw = F32_CASES[name]
    al, th = _rays(n, 3, dtype)
    jt, tt, n_bands = _transfer(kind, A, width, **riaf_kw)
    sj, st, pairs = _both(A, al, th, jt, tt, n_bands, **kw)
    assert len(pairs) == 1 + n_bands and (pairs[-1][1] > 0).sum() > 3
    if dtype == "float64":
        np.testing.assert_array_equal(st, sj)
        for a, b in pairs:
            assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max()
        return
    s64, ref = _jax64(A, al, th, jt, n_bands, **kw)
    g = f32_readings(sj, st, s64, pairs, ref)
    assert g["status_agree"] > 0.99, g
    assert g["gap"] < 1e-3 and g["excess"] <= 1e-4, g


@pytest.mark.parametrize("n_orders", [5, 6])
def test_wide_order_trace_matches_jax(n_orders):
    ac = JKerr(M=M, a=0.0).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(7)
    al = ac * (1.0 + 10.0 ** rng.uniform(-7.0, -1.0, 192))
    th = rng.uniform(-np.pi, np.pi, 192)
    jt, tt, n_bands = _transfer("order", 0.0, n_orders, profile="powerlaw")
    sj, st, pairs = _both(0.0, al, th, jt, tt, n_bands)
    np.testing.assert_array_equal(st, sj)
    m_j, m_t = pairs[0]
    dm = np.abs(m_j - m_t) / np.abs(m_j).max()
    assert np.median(dm) < 1e-9 and dm.max() < 1e-4
    bj = np.stack([b for b, _ in pairs[1:]])
    bt = np.stack([b for _, b in pairs[1:]])
    smoke = _smoke()
    g = smoke.order_numbers(bt, bj)
    assert smoke.order_gate(g), g


def f32_orders(n_orders, seed):
    """An order decomposition in float32 through both packages on 192
    rays of a = 0 away from the critical curve (alpha_crit (1 + eps), eps
    log-uniform in [1e-3, 1]): (JAX statuses, port statuses, the order
    buckets' numbers, chip_smoke.order_numbers, with the winding m's
    median and p99 |d| / max under "m" and the per-ray bucket sums'
    readings, f32_readings's, under "sum")."""
    ac = JKerr(M=M, a=0.0).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(seed)
    al = (ac * (1.0 + 10.0 ** rng.uniform(-3.0, 0.0, 192))).astype(
        np.float32)
    th = rng.uniform(-np.pi, np.pi, 192).astype(np.float32)
    jt, tt, n_bands = _transfer("order", 0.0, n_orders, profile="powerlaw")
    sj, st, pairs = _both(0.0, al, th, jt, tt, n_bands)
    s64, ref = _jax64(0.0, al, th, jt, n_bands)
    bj = np.stack([b for b, _ in pairs[1:]])
    bt = np.stack([b for _, b in pairs[1:]])
    g = _smoke().order_numbers(bt, bj)
    m_j, m_t = pairs[0]
    dm = np.abs(m_j - m_t) / np.abs(m_j).max()
    g["m"] = dict(median=float(np.median(dm)),
                  p99=float(np.percentile(dm, 99)))
    g["sum"] = f32_readings(sj, st, s64, [(bj.sum(0), bt.sum(0))],
                            [np.stack(ref[1:]).sum(0)])
    return sj, st, g


@pytest.mark.parametrize("n_orders", [5, 6])
def test_wide_order_trace_matches_jax_float32(n_orders):
    sj, st, g = f32_orders(n_orders, 7)
    np.testing.assert_array_equal(st, sj)
    smoke = _smoke()
    smoke.order_gate(g)       # fills the bars
    assert g["m"]["median"] < 1e-3, g
    assert g["sum"]["excess"] <= 1e-4, g
    assert g["flux_shift"] < g["flux_shift_bar"], g
    assert min(g["carriers"][:3]) >= 20, g
    assert all(g["flux_rel"][k] < g["flux_bars"][k] for k in (0, 1)), g


def test_wide_widths_route_to_the_broad_instances():
    m = Kerr(M=M, a=A)
    thin = volumetric.RIAFConfig(spot_amp=3.0)
    absorbed = volumetric.RIAFConfig(spot_amp=3.0, alpha0=0.2)
    cases = [
        (volumetric.make_movie_transfer(m, thin, TIMES12), 13, 1, 12),
        (volumetric.make_movie_transfer(m, absorbed, TIMES12[:9]), 11, 2,
         9),
        (volumetric.make_spectral_transfer(m, thin, FREQS33), 34, 0, 33),
        (volumetric.make_order_transfer(m, thin, 5), 6, 3, 5),
        (volumetric.make_order_transfer(m, absorbed, 9), 11, 4, 9)]
    for fn, n_extras, form, width in cases:
        assert vk._family(fn.kernel, n_extras, 0) == (vk.BROAD_ENTRY, form,
                                                      width)
        assert vk.BROAD_FORMS[form].split()[0] in ("spectral", "movie",
                                                   "orders")
    # the narrow widths keep their compiled instances
    eight = volumetric.make_movie_transfer(m, thin, TIMES12[:8])
    assert vk._family(eight.kernel, 9, 0) == ("lpt_kerr_dp45_movie_thin", 0,
                                              8)
    four = volumetric.make_order_transfer(m, absorbed, 4)
    assert vk._family(four.kernel, 6, 0) == ("lpt_kerr_dp45_orders", 1, 4)


def test_broad_constants_and_monitor_words():
    m = Kerr(M=M, a=A)
    riaf = volumetric.RIAFConfig()
    spec = volumetric.make_spectral_transfer(m, riaf, FREQS33).kernel
    k = spec.constants()
    for dtype in (torch.float32, torch.float64):
        c0, c1 = vk.broad_constants(spec, dtype, "cpu")
        assert c0.dtype == c1.dtype == dtype and c0.shape == (33,)
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        assert [float(x) for x in c0] == [float(np_dt(-c)) for c in k["c"]]
        assert [float(x) for x in c1] == [float(np_dt(b))
                                          for b in k["band_scale"]]
    # the narrow struct keeps the first 8 bands, rounded the same way
    p = vk.riaf_params(spec)
    assert list(p.neg_c) == [float(x) for x in vk.broad_constants(
        spec, torch.float32, "cpu")[0][:vk.MAX_BANDS]]
    movie = volumetric.make_movie_transfer(m, riaf, TIMES12).kernel
    (times,) = vk.broad_constants(movie, torch.float32, "cpu")
    assert [float(t) for t in times] == [float(np.float32(t))
                                         for t in TIMES12]
    order = volumetric.make_order_transfer(m, riaf, 6).kernel
    assert vk.broad_constants(order, torch.float64, "cpu") == ()
    words = vk.monitor_words(range(1, 34), 34, "cpu")
    assert words.dtype == torch.int32 and words.shape == (2,)
    bits = [(int(words[e // 32]) >> (e % 32)) & 1 for e in range(34)]
    assert bits == [0] + [1] * 33
    assert ctypes.sizeof(vk.Broad) == 40
