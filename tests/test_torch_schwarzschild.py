"""The PyTorch port's Schwarzschild / Reissner-Nordstrom orbit path
against the JAX package's.

Same inputs, made with numpy from a seed, go through both packages.
  * Closed forms (host float64): relative 1e-12.
  * Batched model functions: float64 to 1e-12 and float32 to 4e-7 (about
    three float32 ulps), each relative to the largest magnitude of the
    compared component. The float32 bound is an ulp scale, not an
    accuracy one: XLA:CPU contracts a*b + c into FMA and the two packages
    take sin/cos from different libraries, so single roundings differ.
    The extracted angle is held through its cosine, since acos is
    ill-conditioned near 0 and pi.
  * The tracer, ~900 rays at alpha in [0.2, 4] alpha_crit plus an
    alpha = 0 lane and one backward ray (alpha > pi/2), against JAX's XLA
    tracer and its Pallas kernel in interpret mode: statuses equal on
    every ray with |alpha - alpha_crit| > 0.05 alpha_crit; on escaped
    stable rays float32 p99 |d final_alpha| < 1e-5 and max < 1e-4,
    float64 max < 1e-8; n_half equal on stable rays; the alpha = 0 lane
    INVALID; and the port's largest per-ray step count equal to the XLA
    loop's global step count (exact: a lane runs while it is RUNNING, and
    the XLA loop stops when the last lane stops).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu.models import ReissnerNordstrom as JRN
from light_path_tracer_tpu.models import Schwarzschild as JS
from light_path_tracer_tpu.ops.schwarzschild_trace import (
    trace_rays_schwarzschild as jtrace)
from light_path_tracer_tpu_torch.models import (ReissnerNordstrom,
                                                Schwarzschild)
from light_path_tracer_tpu_torch.ops import schwarzschild_trace as ts
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.ops.cuda.schwarzschild_kernel import (
    trace_rays_schwarzschild_cuda)

R_OBS = 100.0
RTOL = {"float64": 1e-12, "float32": 4e-7}
DTYPES = ["float64", "float32"]
METRICS = {"schwarzschild": (JS(M=1.0), Schwarzschild(M=1.0)),
           "rn_q0.6": (JRN(M=1.0, Q=0.6), ReissnerNordstrom(M=1.0, Q=0.6))}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, dtype):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL[dtype] * scale)


def _pair(dtype, *arrays):
    """numpy float64 arrays -> (jax arrays, torch CPU tensors) in dtype."""
    j = tuple(jnp.asarray(np.asarray(a, np.dtype(dtype))) for a in arrays)
    t = tuple(torch.from_numpy(np.asarray(a, np.dtype(dtype)))
              for a in arrays)
    return j, t


def _rays(ac, n=900, seed=0):
    """n random rays in [0.2, 4] alpha_crit, then alpha = 0, then one
    backward ray."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.2 * ac, 4.0 * ac, n), [0.0, 2.0]])


@pytest.mark.parametrize("Q", [0.0, 0.3, 0.6, 0.9])
def test_closed_forms_match_jax(Q):
    jm, tm = ((JS(M=1.3), Schwarzschild(M=1.3)) if Q == 0.0
              else (JRN(M=1.3, Q=Q * 1.3), ReissnerNordstrom(M=1.3,
                                                             Q=Q * 1.3)))
    for name in ("R_S", "R_PHOTON", "B_CRIT"):
        assert getattr(tm, name) == pytest.approx(getattr(jm, name),
                                                  rel=1e-12)
    assert tm.capture_radius() == pytest.approx(jm.capture_radius(),
                                                rel=1e-12)
    r = np.array([3.1, 10.0, 57.0, 100.0, 1e4])
    np.testing.assert_allclose(tm.f(r), jm.f(r), rtol=1e-12)
    for r_obs in (30.0, 100.0, 1000.0):
        assert tm.alpha_crit(r_obs) == pytest.approx(jm.alpha_crit(r_obs),
                                                     rel=1e-12)
    al = np.array([0.01, 0.05, 0.3])
    np.testing.assert_allclose(
        tm.viewing_angle_to_impact_parameter(al, R_OBS),
        jm.viewing_angle_to_impact_parameter(al, R_OBS), rtol=1e-12)
    assert tm.is_spherically_symmetric


def test_charge_above_mass_is_rejected():
    with pytest.raises(ValueError):
        ReissnerNordstrom(M=1.0, Q=1.1)
    with pytest.raises(ValueError):
        ReissnerNordstrom(M=1.0, Q=-1.01)
    assert ReissnerNordstrom(M=1.0, Q=1.0).R_S == pytest.approx(1.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", sorted(METRICS))
def test_orbit_initial_state_matches_jax(family, dtype):
    jm, tm = METRICS[family]
    al = _rays(tm.alpha_crit(R_OBS), n=300, seed=1)
    (ja,), (ta,) = _pair(dtype, al)
    ju, jw, jinv = jm.orbit_initial_state(R_OBS, ja)
    tu, tw, tinv = tm.orbit_initial_state(R_OBS, ta)
    assert tu.dtype == tw.dtype == getattr(torch, dtype)
    _close(tu.numpy(), ju, dtype)
    _close(tw.numpy(), jw, dtype)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    assert bool(tinv[-2]) and not bool(tinv[:-2].any())
    assert float(tw[-1]) < 0.0 < float(tw[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", sorted(METRICS))
def test_orbit_rhs_matches_jax(family, dtype):
    jm, tm = METRICS[family]
    rng = np.random.default_rng(2)
    u, w = rng.uniform(0.0, 0.5, 400), rng.uniform(-1.0, 1.0, 400)
    (ju, jw), (tu, tw) = _pair(dtype, u, w)
    for got, ref in zip(tm.orbit_rhs(tu, tw), jm.orbit_rhs(ju, jw)):
        _close(got.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", sorted(METRICS))
def test_orbit_extract_angle_matches_jax(family, dtype):
    jm, tm = METRICS[family]
    rng = np.random.default_rng(3)
    n = 300
    phi = rng.uniform(-40.0, 40.0, n)
    u = rng.uniform(0.004, 0.006, n)
    u[:20] = 1.0 / (1.01 * tm.R_S)      # parked at the capture surface
    w = rng.uniform(-0.05, 0.05, n)
    (jp, ju, jw), (tp, tu, tw) = _pair(dtype, phi, u, w)
    jfa, jnh, jcap = jm.orbit_extract_angle(jp, ju, jw)
    tfa, tnh, tcap = tm.orbit_extract_angle(tp, tu, tw)
    np.testing.assert_array_equal(tnh.numpy(), np.asarray(jnh))
    np.testing.assert_array_equal(tcap.numpy(), np.asarray(jcap))
    assert tcap[:20].all() and not tcap[20:].any()
    # acos is ill-conditioned near 0 and pi, where one ulp of its
    # argument moves the angle by up to sqrt(2 ulp): hold cos(angle) to
    # the ulp scale and the angle itself to sqrt(2 eps) of its dtype.
    tfa, jfa = tfa.numpy().astype(np.float64), np.asarray(jfa, np.float64)
    np.testing.assert_allclose(np.cos(tfa), np.cos(jfa), rtol=0,
                               atol=RTOL[dtype])
    np.testing.assert_allclose(tfa, jfa, rtol=0,
                               atol={"float64": 3e-8, "float32": 1e-3}[dtype])


def _check_trace(rt, jres, al, ac, dtype, steps=None):
    sj, st = np.asarray(jres.status), rt.status.numpy()
    fj, ft = np.asarray(jres.final_alpha), rt.final_alpha.numpy()
    stable = np.abs(al - ac) > 0.05 * ac
    np.testing.assert_array_equal(st[stable], sj[stable])
    ok = stable & (st == 1)
    assert ok.sum() > 500 and ((st == -1) & stable).sum() > 20
    d = np.abs(ft[ok] - fj[ok]).astype(np.float64)
    if dtype == "float64":
        assert d.max() < 1e-8
    else:
        assert np.percentile(d, 99) < 1e-5 and d.max() < 1e-4
    np.testing.assert_array_equal(rt.n_half_orbits.numpy()[stable],
                                  np.asarray(jres.n_half_orbits)[stable])
    assert st[-2] == ts.INVALID and np.isnan(ft[-2])
    assert st[-1] == ts.ESCAPED and sj[-1] == ts.ESCAPED
    assert rt.final_alpha.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", sorted(METRICS))
def test_plain_trace_matches_jax_xla(family, dtype):
    jm, tm = METRICS[family]
    ac = tm.alpha_crit(R_OBS)
    al = _rays(ac)
    (ja,), (ta,) = _pair(dtype, al)
    rj = jtrace(jm, R_OBS, ja)
    rt, steps = ts.trace_rays_schwarzschild(tm, R_OBS, ta, return_steps=True)
    _check_trace(rt, rj, al, ac, dtype)
    assert int(steps.max()) == int(rj.n_steps) > 0
    assert int(steps[-2]) == 0
    assert int(rt.n_steps) == int(ts.warp_step_sum(steps))


@pytest.mark.parametrize("family", sorted(METRICS))
def test_plain_trace_matches_pallas_interpret(family):
    """The Pallas orbit kernel itself, in interpret mode on (8, 128)
    tiles, as the JAX package's own tests run it on the CPU."""
    from light_path_tracer_tpu.ops.pallas.schwarzschild_kernel import (
        trace_rays_schwarzschild_pallas)
    jm, tm = METRICS[family]
    ac = tm.alpha_crit(R_OBS)
    al = _rays(ac)
    (ja,), (ta,) = _pair("float32", al)
    rp = trace_rays_schwarzschild_pallas(jm, R_OBS, ja, tile_rows=8,
                                         interpret=True)
    rt = ts.trace_rays_schwarzschild(tm, R_OBS, ta)
    _check_trace(rt, rp, al, ac, "float32")


def test_trace_batch_spherical_branch_on_cpu():
    tm = Schwarzschild(M=1.0)
    al = torch.from_numpy(_rays(tm.alpha_crit(R_OBS), n=64).astype(
        np.float32))
    calls = ts.trace_rays_schwarzschild.launches
    got = trace_batch(tm, R_OBS, al, phi_max=30.0, h_max=0.1)
    want = ts.trace_rays_schwarzschild(tm, R_OBS, al, 30.0, 0.1)
    assert ts.trace_rays_schwarzschild.launches == calls + 2
    np.testing.assert_array_equal(got.status.numpy(), want.status.numpy())
    np.testing.assert_array_equal(got.final_alpha.numpy(),
                                  want.final_alpha.numpy())
    assert int(got.n_steps) == int(want.n_steps) > 0
    with pytest.raises(ValueError):
        trace_batch(tm, R_OBS, al, backend="xla")
    empty = trace_batch(tm, R_OBS, torch.zeros(0))
    assert empty.status.shape == (0,) and int(empty.n_steps) == 0


def test_phi_max_bounds_the_steps():
    """A ray on the photon sphere winds until phi_max: it runs exactly
    ceil(phi_max / h_max) steps and folds into ESCAPED or CAPTURED."""
    tm = Schwarzschild(M=1.0)
    al = torch.tensor([tm.alpha_crit(R_OBS)], dtype=torch.float64)
    res, steps = ts.trace_rays_schwarzschild(tm, R_OBS, al, phi_max=5.0,
                                             h_max=0.05, return_steps=True)
    assert int(steps[0]) == 100 and int(res.status[0]) in (1, -1)


def test_cuda_wrapper_runs_plain_version_on_cpu():
    tm = ReissnerNordstrom(M=1.0, Q=0.6)
    al = torch.from_numpy(_rays(tm.alpha_crit(R_OBS), n=64).astype(
        np.float32))
    launches = trace_rays_schwarzschild_cuda.launches
    calls = ts.trace_rays_schwarzschild.launches
    got = trace_rays_schwarzschild_cuda(tm, R_OBS, al)
    want = ts.trace_rays_schwarzschild(tm, R_OBS, al)
    assert trace_rays_schwarzschild_cuda.launches == launches
    assert ts.trace_rays_schwarzschild.launches == calls + 2
    np.testing.assert_array_equal(got.status.numpy(), want.status.numpy())
    with pytest.raises(ValueError):
        trace_rays_schwarzschild_cuda(tm, R_OBS, al.to("meta"))
