"""The PyTorch port's plain Kerr DP45 loop against the JAX package.

512 rays, made with numpy from a seed, go through the JAX
`trace_rays_kerr` (XLA on the CPU) and the port's `trace_rays_kerr`.
Criteria, as in tests/test_pallas.py:
  * float64: identical statuses and |d final_alpha| < 1e-8 on the stable
    population (escaped in both, |alpha - alpha_crit| > 0.05 alpha_crit);
  * float32: status agreement above 0.99 and p99 |d final_alpha| < 1e-3
    on the stable population (different sin/cos roundings change step
    sequences at the tolerance level).
One more case runs the Pallas kernel itself in interpret mode, as the
JAX tests do, on the two rays of test_pallas_invalid_and_captured_lanes.
The CUDA kernel against this loop runs on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr as jtrace
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
    trace_rays_kerr_cuda)

R_OBS = 100.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rays(n, seed, ac):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3 * ac, 4 * ac, n), rng.uniform(-np.pi, np.pi, n),
            rng.random(n) < 0.2)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_trace_matches_jax(dtype):
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    ac = jm.alpha_crit(R_OBS)
    al, th, ref = _rays(512, 0, ac)
    npdt = np.dtype(dtype)
    rj = jtrace(jm, R_OBS, jnp.asarray(al, npdt), jnp.asarray(th, npdt),
                np.pi / 2, jnp.asarray(ref), 5000.0, 5000)
    rt = tk.trace_rays_kerr(tm, R_OBS, torch.from_numpy(al.astype(npdt)),
                            torch.from_numpy(th.astype(npdt)), np.pi / 2,
                            torch.from_numpy(ref), 5000.0, 5000)
    sj, st = np.asarray(rj.status), rt.status.numpy()
    fj, ft = np.asarray(rj.final_alpha), rt.final_alpha.numpy()
    assert rt.final_alpha.dtype == getattr(torch, dtype)
    both = (sj == 1) & (st == 1)
    stable = both & (np.abs(al - ac) > 0.05 * ac)
    assert stable.sum() > 300 and (sj == -1).sum() > 20
    d = np.abs(fj[stable] - ft[stable])
    if dtype == "float64":
        np.testing.assert_array_equal(st, sj)
        assert d.max() < 1e-8
        np.testing.assert_array_equal(rt.n_half_orbits.numpy()[stable],
                                      np.asarray(rj.n_half_orbits)[stable])
    else:
        assert (sj == st).mean() > 0.99
        assert np.percentile(d, 99) < 1e-3
    # The whole-batch JAX loop counts its global iterations: a lower
    # bound of the port's per-warp sum, which is at most 16 warps of it.
    assert int(rj.n_steps) <= int(rt.n_steps) <= 16 * int(rj.n_steps)


def test_plain_trace_matches_pallas_interpret():
    """The Pallas tile kernel itself (interpret mode, one (8, 128) tile),
    on a deep-shadow ray and an escaping ray."""
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_rays_kerr_pallas)
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    ac = jm.alpha_crit(R_OBS)
    al = np.asarray([0.2 * ac, 2.0 * ac], np.float32)
    th = np.asarray([0.3, 1.0], np.float32)
    rp = trace_rays_kerr_pallas(
        jm, R_OBS, jnp.asarray(al), jnp.asarray(th), np.pi / 2,
        jnp.zeros(2, bool), 5000.0, 5000, tile_rows=8, interpret=True)
    rt = tk.trace_rays_kerr(tm, R_OBS, torch.from_numpy(al),
                            torch.from_numpy(th), np.pi / 2,
                            torch.zeros(2, dtype=torch.bool), 5000.0, 5000)
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rp.status))
    assert rt.status.tolist() == [-1, 1]
    assert abs(float(rt.final_alpha[1]) - float(rp.final_alpha[1])) < 1e-3
    assert np.isnan(float(rt.final_alpha[0]))


def test_warp_step_sum_hand_built():
    # One full warp and a ragged one: max(1..32) + max(33..40).
    attempts = torch.arange(1, 41, dtype=torch.int32)
    assert int(tk.warp_step_sum(attempts)) == 32 + 40
    # Order inside a warp does not matter; a later warp is separate.
    a = torch.tensor([5] * 31 + [90] + [7], dtype=torch.int32)
    assert int(tk.warp_step_sum(a)) == 90 + 7
    assert tk.warp_step_sum(a).dtype == torch.int64
    assert int(tk.warp_step_sum(torch.zeros(0, dtype=torch.int32))) == 0


def test_plain_n_steps_is_per_warp_max_of_attempts():
    """n_steps of a trace is the per-warp maximum of per-ray attempts,
    and a ray's attempts do not depend on its batch: 34 rays count the
    first warp's 32 plus the larger of the last two rays' own counts."""
    tm = Kerr(M=1.0, a=0.9)
    ac = tm.alpha_crit(R_OBS)
    al, th, ref = _rays(34, 5, ac)
    al, th = al.astype(np.float32), th.astype(np.float32)

    def trace(sl):
        return tk.trace_rays_kerr(
            tm, R_OBS, torch.from_numpy(al[sl]), torch.from_numpy(th[sl]),
            np.pi / 2, torch.from_numpy(ref[sl]), 5000.0, 5000)

    whole = trace(slice(0, 34))
    first_warp = trace(slice(0, 32))
    singles = [trace(slice(i, i + 1)) for i in (32, 33)]
    assert int(whole.n_steps) == int(first_warp.n_steps) + max(
        int(s.n_steps) for s in singles)
    np.testing.assert_array_equal(
        whole.status.numpy(),
        np.concatenate([first_warp.status.numpy()]
                       + [s.status.numpy() for s in singles]))


# 288 rays in chunks of 128 (padded to 384): every batch a multiple of 32,
# so the plain loop's vectorised body covers each lane in both batchings
# (a scalar tail may round sin and cos otherwise). Every seventh alpha is
# one value, so the difficulty sort meets exact ties.
CHUNK_N, CHUNK = 288, 128


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chunked_trace_batch_matches_jax_and_whole_batch(dtype, sort):
    """The chunked branch, sorted and unsorted, against the JAX package's
    on the same rays (statuses equal on >= 99.9 %; final alpha of rays
    escaped in both within 1e-8 in float64, p99 < 2e-3 in float32) and
    bitwise against the port's own whole-batch trace."""
    from light_path_tracer_tpu.ops.batch import trace_batch as jbatch
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    ac = jm.alpha_crit(R_OBS)
    al, th, ref = _rays(CHUNK_N, 7, ac)
    al[::7] = al[0]
    npdt = np.dtype(dtype)
    args = (torch.from_numpy(al.astype(npdt)),
            torch.from_numpy(th.astype(npdt)), np.pi / 2,
            torch.from_numpy(ref))
    whole = trace_batch(tm, R_OBS, *args, max_steps=5000)
    got = trace_batch(tm, R_OBS, *args, chunk_size=CHUNK,
                      sort_by_difficulty=sort, max_steps=5000)
    want = jbatch(jm, R_OBS, jnp.asarray(al, npdt), jnp.asarray(th, npdt),
                  np.pi / 2, jnp.asarray(ref), chunk_size=CHUNK,
                  sort_by_difficulty=sort, max_steps=5000)
    for a, b in zip(got[:3], whole[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got.final_alpha.dtype == getattr(torch, dtype)
    assert got.n_steps.dtype == torch.int64 and int(got.n_steps) > 0
    sj, st = np.asarray(want.status), got.status.numpy()
    assert (sj == st).mean() >= 0.999
    both = (sj == 1) & (st == 1)
    assert both.sum() > 150
    d = np.abs(np.asarray(want.final_alpha)[both]
               - got.final_alpha.numpy()[both])
    if dtype == "float64":
        assert d.max() < 1e-8
    else:
        assert np.percentile(d, 99) < 2e-3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_difficulty_order_matches_jax_argsort(dtype):
    """The chunked branch's order (ops.batch.difficulty_order) is
    jnp.argsort's on a camera alpha grid, whose exact ties a sort that is
    not stable would reorder (and so move rays between chunks)."""
    from light_path_tracer_tpu.camera import build_alpha_lookup
    from light_path_tracer_tpu_torch.ops.batch import difficulty_order
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    res = (24, 32)
    fov = (np.radians(40.0), np.radians(30.0))
    al = np.array(build_alpha_lookup(res, fov, dtype=dtype)).reshape(-1)
    assert np.unique(al).size < al.size // 2
    want = np.asarray(jnp.argsort(jnp.abs(
        jnp.asarray(al) - jm.alpha_crit(R_OBS, np.pi / 2))))
    got = difficulty_order(tm, R_OBS, np.pi / 2, torch.from_numpy(al))
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_trace_batch_spherical_ignores_chunks():
    """Spherically symmetric metrics return before the chunk code, in
    both packages."""
    from light_path_tracer_tpu_torch.models import Schwarzschild
    al = torch.linspace(0.01, 0.5, 40, dtype=torch.float64)
    whole = trace_batch(Schwarzschild(M=1.0), R_OBS, al)
    got = trace_batch(Schwarzschild(M=1.0), R_OBS, al, chunk_size=7)
    for a, b in zip(got, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cuda_wrapper_runs_plain_version_on_cpu():
    tm = Kerr(M=1.0, a=0.9)
    ac = tm.alpha_crit(R_OBS)
    al, th, ref = _rays(64, 6, ac)
    args = (torch.from_numpy(al.astype(np.float32)),
            torch.from_numpy(th.astype(np.float32)), np.pi / 2,
            torch.from_numpy(ref), 5000.0, 5000)
    kernel_launches = trace_rays_kerr_cuda.launches
    plain_calls = tk.trace_rays_kerr.launches
    got = trace_rays_kerr_cuda(tm, R_OBS, *args)
    want = tk.trace_rays_kerr(tm, R_OBS, *args)
    assert trace_rays_kerr_cuda.launches == kernel_launches
    assert tk.trace_rays_kerr.launches == plain_calls + 2
    np.testing.assert_array_equal(got.status.numpy(), want.status.numpy())
    np.testing.assert_array_equal(got.final_alpha.numpy(),
                                  want.final_alpha.numpy())


def test_trace_batch_rejects_branches_not_ported(tmp_path):
    tm = Kerr(M=1.0, a=0.9)
    al = torch.full((8,), 0.1)
    # Progress bars and chunk stores are ported
    # (tests/test_torch_telemetry.py): they trace as without them.
    from light_path_tracer_tpu_torch.checkpoint import ChunkStore
    whole = trace_batch(tm, R_OBS, al)
    for kwargs in (dict(chunk_size=4, progress=True),
                   dict(chunk_size=4, chunk_store=ChunkStore(
                       str(tmp_path), "k")), dict(progress="live")):
        res = trace_batch(tm, R_OBS, al, **kwargs)
        assert torch.equal(res.status, whole.status)
    # The fixed-step RK4 is ported (tests/test_torch_rk4.py).
    res = trace_batch(tm, R_OBS, al, integrator="rk4")
    assert res.status.shape == (8,) and int(res.n_steps) > 0
    # formulation="mu" is ported (tests/test_torch_mu.py); an unknown
    # chart is a ValueError.
    for kwargs in (dict(backend="pallas"), dict(integrator="rk45"),
                   dict(event_interp="cubic"), dict(formulation="cos")):
        with pytest.raises(ValueError):
            trace_batch(tm, R_OBS, al, **kwargs)
    empty = trace_batch(tm, R_OBS, torch.zeros(0))
    assert empty.final_alpha.shape == (0,) and int(empty.n_steps) == 0
    # The loop itself: extra state components, the saturation exits,
    # DOP853, linear events, the mu chart, tilted and further disk planes
    # and the time recorder are ported; the time recorder without a
    # plane, an unknown pair or chart is a ValueError, as is the mu chart
    # with a disk plane.
    one = torch.ones(8)
    loop = dict(atol=one, rtol=one, h_min=torch.tensor(1e-7), tiny_err=1e-8,
                r_capture=torch.tensor(2.0), r_escape=torch.tensor(200.0),
                lambda_max=10.0, h_init=1.0, max_steps=2)
    plane = (2.0, 9.0, 1.0, True)
    basis = ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    for kwargs, key in ((dict(disk_normal=basis), "xi"),
                        (dict(extra_disks=[(plane, None)]), "extra"),
                        (dict(record_time=True), "t_now")):
        out = tk.dp45_integrate(tm, torch.ones((5, 8)), -one, one,
                                torch.full((8,), 2, dtype=torch.int32),
                                **loop, disk_plane=plane, **kwargs)
        assert key in out[4]
    with pytest.raises(ValueError):
        tk.dp45_integrate(tm, torch.ones((5, 8)), -one, one,
                          torch.full((8,), 2, dtype=torch.int32), **loop,
                          record_time=True)
    for kwargs in (dict(formulation="cos"),
                   dict(formulation="mu", disk_plane=(2.0, 9.0, 1.0, True))):
        with pytest.raises(ValueError):
            tk.dp45_integrate(tm, torch.ones((5, 8)), -one, one,
                              torch.full((8,), 2, dtype=torch.int32),
                              **loop, **kwargs)
    y, status, lam, attempts = tk.dp45_integrate(
        tm, torch.full((6, 8), 50.0), -one, 0.1 * one,
        torch.full((8,), 2, dtype=torch.int32), **loop,
        extra_rhs=lambda y, pt, pp: (torch.ones_like(pt),), sat_window=4,
        sat_monitor=(0,), sat_r_max=5.0)
    assert y.shape == (6, 8) and int(attempts.max()) <= 2


def _grid_rays(n, seed=7):
    tm = Kerr(M=1.0, a=0.9)
    al, th, ref = _rays(n, seed, tm.alpha_crit(R_OBS))
    return (tm, torch.from_numpy(al.astype(np.float32)),
            torch.from_numpy(th.astype(np.float32)), torch.from_numpy(ref))


@pytest.mark.parametrize("pass1_steps", [4, 16])
def test_kerr_two_pass_equals_single_pass(pass1_steps):
    """The driver on the plain loop: every ray is re-traced or finished in
    pass 1, and both agree exactly with one uncapped pass."""
    tm, al, th, ref = _grid_rays(256)
    args = (tm, R_OBS, al, th, np.pi / 2, ref, 5000.0, 5000)
    one = tk.trace_rays_kerr(*args)
    first, unconv = tk.trace_rays_kerr(*args[:7], pass1_steps,
                                       return_unconverged=True)
    assert 0 < int(unconv.sum()) <= 256
    launches = kk.trace_rays_kerr_two_pass.launches
    two = kk.trace_rays_kerr_two_pass(*args, pass1_steps=pass1_steps)
    assert kk.trace_rays_kerr_two_pass.launches == launches + 1
    assert torch.equal(two.status, one.status)
    assert torch.equal(two.n_half_orbits, one.n_half_orbits)
    assert torch.equal(two.final_alpha.nan_to_num(9.0),
                       one.final_alpha.nan_to_num(9.0))
    # n_steps counts both passes
    assert int(two.n_steps) > int(first.n_steps)


def test_kerr_two_pass_keeps_pass_one_beyond_slots():
    tm, al, th, ref = _grid_rays(256)
    args = (tm, R_OBS, al, th, np.pi / 2, ref, 5000.0, 5000)
    one = tk.trace_rays_kerr(*args)
    first, unconv = tk.trace_rays_kerr(*args[:7], 4, return_unconverged=True)
    idx = torch.nonzero(unconv)[:, 0]
    assert idx.numel() > 32
    two = kk.trace_rays_kerr_two_pass(*args, pass1_steps=4, slots=32)
    retraced = torch.zeros_like(unconv)
    retraced[idx[:32]] = True
    for a, b, c in zip(one[:3], two[:3], first[:3]):
        a, b, c = (x.nan_to_num(9.0) if x.is_floating_point() else x
                   for x in (a, b, c))
        assert torch.equal(b[retraced], a[retraced])
        assert torch.equal(b[~retraced], c[~retraced])


def test_trace_batch_two_pass_matches_reference_on_cpu():
    """Off the kernel two_pass changes nothing, as in the JAX package,
    whose XLA branch ignores it: with two_pass=True and an 8-attempt
    first pass both packages give the single pass's float64 result, and
    the port's step count is its single pass's (a two-pass driver would
    count both passes)."""
    from light_path_tracer_tpu.ops.batch import trace_batch as jbatch
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    al, th, ref = _rays(64, 11, jm.alpha_crit(R_OBS))
    rj = jbatch(jm, R_OBS, jnp.asarray(al), jnp.asarray(th), np.pi / 2,
                jnp.asarray(ref), max_steps=5000, backend="xla",
                two_pass=True, pass1_steps=8)
    args = (tm, R_OBS, torch.from_numpy(al), torch.from_numpy(th),
            np.pi / 2, torch.from_numpy(ref))
    two = trace_batch(*args, max_steps=5000, two_pass=True, pass1_steps=8)
    one = trace_batch(*args, max_steps=5000, two_pass=False)
    sj = np.asarray(rj.status)
    np.testing.assert_array_equal(two.status.numpy(), sj)
    np.testing.assert_array_equal(two.n_half_orbits.numpy(),
                                  np.asarray(rj.n_half_orbits))
    esc = sj == 1
    assert esc.sum() > 20 and (sj == -1).sum() > 5
    assert np.abs(two.final_alpha.numpy()[esc]
                  - np.asarray(rj.final_alpha)[esc]).max() < 1e-8
    assert int(two.n_steps) == int(one.n_steps)
    assert torch.equal(two.final_alpha.nan_to_num(9.0),
                       one.final_alpha.nan_to_num(9.0))


def test_trace_batch_two_pass_rule(monkeypatch):
    """On the kernel path two_pass=True runs the driver and 'auto' turns it
    on above 2,000,000 rays only (the JAX package's rule for its kernel);
    the plain loop ignores two_pass, as the JAX package's XLA branch
    does."""
    from light_path_tracer_tpu_torch.ops import batch
    tm, al, th, ref = _grid_rays(64)
    single = trace_batch(tm, R_OBS, al, th, np.pi / 2, ref, max_steps=5000)
    launches = kk.trace_rays_kerr_two_pass.launches
    plain = tk.trace_rays_kerr.launches
    two = trace_batch(tm, R_OBS, al, th, np.pi / 2, ref, max_steps=5000,
                      two_pass=True, pass1_steps=8)
    assert kk.trace_rays_kerr_two_pass.launches == launches
    assert tk.trace_rays_kerr.launches == plain + 1
    for a, b in zip(two[:4], single[:4]):
        assert torch.equal(a.nan_to_num(9.0) if a.is_floating_point() else a,
                           b.nan_to_num(9.0) if b.is_floating_point() else b)
    calls = []

    def fake(name):
        def run(metric, r_obs, alphas, *args, **kwargs):
            calls.append((name, int(alphas.numel()),
                          kwargs.get("pass1_steps")))
            return single
        return run

    monkeypatch.setattr(kk, "trace_rays_kerr_two_pass", fake("two"))
    monkeypatch.setattr(kk, "trace_rays_kerr_cuda", fake("kernel"))
    monkeypatch.setattr(tk, "trace_rays_kerr", fake("plain"))
    big = torch.full((2_000_001,), 0.1)
    trace_batch(tm, R_OBS, big, pass1_steps=99)
    trace_batch(tm, R_OBS, big, two_pass=True)
    monkeypatch.setattr(batch, "_backend", lambda backend, alphas: "cuda")
    for n in (2_000_000, 2_000_001):
        trace_batch(tm, R_OBS, big[:n], pass1_steps=99)
    trace_batch(tm, R_OBS, big, two_pass=False)
    trace_batch(tm, R_OBS, big[:64], two_pass=True, pass1_steps=7)
    assert calls == [("plain", 2_000_001, None), ("plain", 2_000_001, None),
                     ("kernel", 2_000_000, None), ("two", 2_000_001, 99),
                     ("kernel", 2_000_001, None), ("two", 64, 7)]
