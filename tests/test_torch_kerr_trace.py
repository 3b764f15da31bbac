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


def test_trace_batch_rejects_branches_not_ported():
    tm = Kerr(M=1.0, a=0.9)
    al = torch.full((8,), 0.1)
    for kwargs in (dict(chunk_size=4), dict(two_pass=True),
                   dict(integrator="dop853"), dict(event_interp="linear"),
                   dict(formulation="mu")):
        with pytest.raises(NotImplementedError):
            trace_batch(tm, R_OBS, al, **kwargs)
    with pytest.raises(ValueError):
        trace_batch(tm, R_OBS, al, backend="pallas")
    empty = trace_batch(tm, R_OBS, torch.zeros(0))
    assert empty.final_alpha.shape == (0,) and int(empty.n_steps) == 0
