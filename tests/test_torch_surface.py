"""The port's surface trace (ops/kerr_trace.py trace_rays_surface, the
plain version of the CUDA surface kernel) against the JAX package's
XLA loop, and the wrapper's route (ops/cuda/surface_kernel.py).

Inputs: 128 rays made from a numpy seed, alpha in [0.01, 0.2] rad about
alpha_crit ~ 0.05 at r_obs = 100 M, theta uniform, theta_obs = 80 deg,
r_surface the capture radius, so both captured and escaped rays occur.
Both packages trace on the CPU. Criteria:
  * float64: identical statuses and windings; every field (theta, phi,
    p_r, p_theta, xi, t_hit, final_alpha) within 1e-9 relative of JAX's
    on rays finite in both (relative to the larger magnitude, floored
    at 1e-6 of the field's largest);
  * float32: status agreement >= 0.99 between the packages; on escaped
    rays each field of each package's float32 trace within 1e-3 of the
    field's largest value (p99) of JAX's float64 trace of the same rays.
    (Under DOP853 the port's float32 error reads up to 5 x JAX's, both
    below the bar: the pair's float32 step sequences are chaotic,
    ROADMAP Queue 3 #8.)
DP45 runs both dtypes with and without the time component; DOP853 runs
both dtypes with it in tests/test_torch_surface_dop853.py (the time
component is the same extra state under either pair; JAX compiles each
DOP853 loop for ~15-20 s on this host); Kerr-Newman and
Johannsen-Psaltis run float64 DP45 with it.
"""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models import JohannsenPsaltis as JJP
from light_path_tracer_tpu.models import KerrNewman as JKN
from light_path_tracer_tpu.ops import kerr_trace as jkt
from light_path_tracer_tpu_torch.convert import metric_from_jax
from light_path_tracer_tpu_torch.ops import kerr_trace as tkt
from light_path_tracer_tpu_torch.ops.cuda import _build
from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk

R_OBS = 100.0
THETA_OBS = float(np.radians(80.0))
MAX_STEPS = 20000
FIELDS = ("theta", "phi", "p_r", "p_theta", "xi", "t_hit", "final_alpha")
METRICS = {"kerr": JKerr(M=1.0, a=0.9),
           "kerr_newman": JKN(M=1.0, a=0.6, Q=0.6),
           "johannsen_psaltis": JJP(M=1.0, a=0.9, eps3=2.0)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rays(n=128, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.01, 0.2, n), rng.uniform(-np.pi, np.pi, n)


@functools.lru_cache(maxsize=None)
def _jax(family, dtype, method, record_time):
    al, th = _rays()
    jm = METRICS[family]
    res = jkt.trace_rays_surface(
        jm, R_OBS, jnp.asarray(al, dtype), jnp.asarray(th, dtype),
        THETA_OBS, r_surface=float(jm.capture_radius()),
        lambda_max=max(5000.0, 6.0 * R_OBS), max_steps=MAX_STEPS,
        method=method, record_time=record_time)
    return {k: np.asarray(v) for k, v in res._asdict().items()}


def _port(family, dtype, method, record_time):
    al, th = _rays()
    m = metric_from_jax(METRICS[family])
    tdt = getattr(torch, dtype)
    res = sk.trace_rays_surface_cuda(
        m, R_OBS, torch.tensor(al, dtype=tdt), torch.tensor(th, dtype=tdt),
        THETA_OBS, r_surface=float(m.capture_radius()),
        lambda_max=max(5000.0, 6.0 * R_OBS), max_steps=MAX_STEPS,
        method=method, record_time=record_time)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in res._asdict().items()}


def _rel64(a, b):
    ok = np.isfinite(a) & np.isfinite(b)
    a, b = a[ok].astype(np.float64), b[ok].astype(np.float64)
    floor = 1e-6 * max(float(np.abs(a).max()) if a.size else 0.0, 1e-300)
    return float((np.abs(a - b) / np.maximum(np.maximum(np.abs(a),
                                                        np.abs(b)),
                                             floor)).max()) if a.size else 0.0


def _check_f64(j, t, record_time):
    assert np.array_equal(j["status"], t["status"])
    assert np.array_equal(j["n_half_orbits"], t["n_half_orbits"])
    assert (t["status"] == 1).sum() > 10 and (t["status"] == -1).sum() > 10
    for k in FIELDS:
        assert _rel64(j[k], t[k]) < 1e-9, k
    if not record_time:
        assert not t["t_hit"].any()
    else:
        assert np.all(t["t_hit"][t["status"] == 1] > 2.0 * R_OBS)
    assert int(t["n_steps"]) > 0


def _check_f32(j32, t32, j64):
    agree = (j32["status"] == t32["status"]).mean()
    assert agree >= 0.99, agree
    esc = ((j64["status"] == 1) & (j32["status"] == 1)
           & (t32["status"] == 1))
    assert esc.sum() > 20
    for k in FIELDS:
        ref = j64[k][esc]
        scale = max(float(np.abs(ref).max()), 1e-30)
        e_j = np.percentile(np.abs(j32[k][esc] - ref), 99) / scale
        e_t = np.percentile(np.abs(t32[k][esc] - ref), 99) / scale
        assert e_j < 1e-3 and e_t < 1e-3, (k, e_j, e_t)


def check_kerr(method, dtype, record_time):
    """The Kerr surface trace of one pair, dtype and time setting against
    JAX's by the dtype's criteria."""
    t = _port("kerr", dtype, method, record_time)
    if dtype == "float64":
        _check_f64(_jax("kerr", dtype, method, record_time), t, record_time)
    else:
        _check_f32(_jax("kerr", dtype, method, record_time), t,
                   _jax("kerr", "float64", method, record_time))


@pytest.mark.parametrize("dtype,record_time", [
    ("float64", False), ("float64", True), ("float32", False),
    ("float32", True)])
def test_surface_trace_kerr_matches_jax(dtype, record_time):
    check_kerr("dp45", dtype, record_time)


@pytest.mark.parametrize("family", ["kerr_newman", "johannsen_psaltis"])
def test_surface_trace_families_match_jax(family):
    _check_f64(_jax(family, "float64", "dp45", True),
               _port(family, "float64", "dp45", True), True)


def test_surface_captured_rays_end_on_the_sphere():
    """A captured ray's raw state lies on r = r_surface (the event's
    Hermite root), at a larger sphere too: the surface is the capture
    event, whatever its radius."""
    m = metric_from_jax(METRICS["kerr"])
    al, th = _rays(64, seed=1)
    for r_s in (float(m.capture_radius()), 6.0):
        res = tkt.trace_rays_surface(
            m, R_OBS, torch.tensor(al), torch.tensor(th), THETA_OBS, r_s,
            6.0 * R_OBS * 10, MAX_STEPS)
        cap = res.status == -1
        assert int(cap.sum()) > 5
        assert res.final_alpha[cap].isnan().all()
        assert torch.isfinite(res.theta[cap]).all()


def test_surface_wrapper_routes():
    """CPU tensors run the plain loop; a device without a kernel, a
    metric outside the kernel's families and an unknown pair raise."""
    m = metric_from_jax(METRICS["kerr"])
    al, th = (torch.tensor(x[:8]) for x in _rays())
    n0 = tkt.trace_rays_surface.launches
    sk.trace_rays_surface_cuda(m, R_OBS, al, th, THETA_OBS, 1.5, 5000.0,
                               100)
    assert tkt.trace_rays_surface.launches == n0 + 1
    assert not any(sk.launches().values())
    with pytest.raises(ValueError):
        sk.trace_rays_surface_cuda(m, R_OBS, al.to("meta"), th.to("meta"),
                                   THETA_OBS, 1.5, 5000.0, 100)
    with pytest.raises(ValueError):
        tkt.trace_rays_surface(m, R_OBS, al, th, THETA_OBS, 1.5, 5000.0,
                               100, method="rk45")


def test_surface_call_layout_and_library():
    """The ctypes mirrors have the sizes the kernel's static_asserts pin
    (csrc/kerr_surface.cuh), and the "surface" library holds the four
    sources, the float64 ones as relocatable device code."""
    assert ctypes.sizeof(sk.SurfaceCall) == 168
    assert ctypes.sizeof(sk.SurfaceCall64) == 232
    names = [s.name for s in _build._sources("surface")]
    assert names == ["kerr_surface.cu", "kerr_surface_dop853.cu",
                     "kerr_surface_dop853_f64.cu", "kerr_surface_f64.cu"]
    assert [_build._rdc_source(n) for n in names] == [False, False, True,
                                                      True]
    for lib in ("dp45", "more", "dop853", "broad"):
        assert not any(s.name.startswith("kerr_surface")
                       for s in _build._sources(lib))
