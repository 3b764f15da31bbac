"""The Kerr trace's run-time (M, a) and (M, a, r_obs) against the JAX package.

The port's `dynamic_params` (the sequences' traced parameters in JAX):
  * TracedKerr's float32 scalars, r_+ = M + sqrt(max(M M - a a, 0)), the
    capture radius r_+ 1.01, the reclassification radius (r_+ 1.01) 1.1
    and the freeze radius r_+ 1.001, bitwise equal to JAX's eager
    TracedKerr on 2,006 (M, a) pairs; the run-time first step max(1,
    0.01 r_obs) bitwise JAX's _h_init_for of a float32 radius. (Under
    jit XLA:CPU rounds some of them otherwise: it contracts M M - a a
    into a fused multiply-add and folds the two reclassification
    factors, ~10 % and ~50 % of these pairs; the eager values are what
    the operations as written give.)
  * the plain loop's trace_rays_kerr(dynamic_params=...) against JAX's
    trace_rays_kerr_pallas(..., interpret=True, dynamic_params=...) on 128
    rays (alpha in [0.3, 4] alpha_crit), theta chart and mu chart (the
    pole-risk rays poisoned and the attempts capped at 512, as in the
    hybrid's first pass on the card), with (M, a)
    = (1.3, 1.17) at r_obs 104 and (M, a, r_obs) = (1.3, 1.17, 104):
    statuses equal on every ray; final alpha on rays escaped in both
    within 5e-4 rad in theta (measured 9.5e-5: torch's and XLA's float32
    sin, cos and pow round apart, ROADMAP Queue 3 #6; the static traces
    part by as much) and 2e-3 in mu (measured 6.7e-4);
  * the hybrid (JAX backend "xla") with dynamic_params on a 16^2 grid
    holding the pole column, both passes: statuses equal and final alpha
    within the theta bar (measured 2.7e-4);
  * float64 with dynamic_params raises ValueError in the plain loop, the
    plain hybrid and the CUDA wrappers given CPU tensors, as JAX's
    Pallas path does.
The CUDA launch with run-time scalars is held against this plain loop on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 28).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models.kerr import TracedKerr as JTraced
from light_path_tracer_tpu.ops.kerr_trace import _h_init_for as j_h_init
from light_path_tracer_tpu.ops.kerr_trace import (
    trace_rays_kerr_hybrid as jhybrid)
from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
    trace_rays_kerr_pallas as jpallas)
from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.models import Kerr, TracedKerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk

M, A, R_OBS = 1.3, 1.17, 104.0
N = 128
DYN = {2: (M, A), 3: (M, A, R_OBS)}
TOL = {"theta": 5e-4, "mu": 2e-3}
MU_STEPS = 512


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pairs():
    rng = np.random.default_rng(0)
    cases = [(1.0, a) for a in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0)]
    return cases + [(float(m), float(m * f)) for m, f in zip(
        rng.uniform(0.3, 3.0, 2000), rng.uniform(0.0, 1.0, 2000))]


def test_traced_kerr_scalars_bitwise():
    bad = []
    for m, a in _pairs():
        j = JTraced(jnp.float32(m), jnp.float32(a))
        ref = (j.M, j.a, j.r_plus, j.capture_radius(),
               j.capture_radius() * 1.1, j._freeze_radius())
        p = TracedKerr(m, a)
        got = (p.M, p.a, p.r_plus, p.capture_radius(), p.reclass_radius(),
               p._freeze_radius())
        for name, r, g in zip(("M", "a", "r_plus", "capture", "reclass",
                               "freeze"), ref, got):
            assert np.asarray(r).dtype == np.float32
            if float(r) != g:
                bad.append((m, a, name, float(r), g))
    assert not bad, bad[:10]


@pytest.mark.parametrize("r_obs", [20.0, 37.3, 63.7, 100.0, 104.0, 150.5,
                                   200.0, 999.9])
def test_run_time_first_step_bitwise(r_obs):
    ref = float(j_h_init(jnp.float32(r_obs), jnp.float32))
    assert tk._h_init_for(torch.tensor(r_obs, dtype=torch.float32)) == ref
    # a Python radius keeps the static float64 form
    assert tk._h_init_for(r_obs) == max(1.0, 0.01 * r_obs)


def _rays():
    ac = JKerr(M=M, a=A).alpha_crit(R_OBS)
    rng = np.random.default_rng(17)
    return (rng.uniform(0.3 * ac, 4 * ac, N).astype(np.float32),
            rng.uniform(-np.pi, np.pi, N).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _pair(form, n_scalars):
    al, th = _rays()
    dyn = DYN[n_scalars]
    steps = MU_STEPS if form == "mu" else 20000
    kw, pkw = {}, {}
    if form == "mu":
        risk = np.asarray(JTraced(jnp.float32(M), jnp.float32(A)).pole_risk(
            jnp.float32(R_OBS), jnp.asarray(al), jnp.asarray(th),
            np.pi / 2, 1e-3))
        kw = dict(formulation="mu", force_invalid=jnp.asarray(risk))
        pkw = dict(formulation="mu", force_invalid=torch.tensor(risk))
    rj = jpallas(JKerr(M=1.0, a=0.0), R_OBS if n_scalars == 2 else 999.0,
                 jnp.asarray(al), jnp.asarray(th), np.pi / 2,
                 jnp.zeros(N, bool), 5000.0, steps, interpret=True,
                 tile_rows=1, dynamic_params=tuple(jnp.float32(x)
                                                   for x in dyn), **kw)
    rp = tk.trace_rays_kerr(
        Kerr(M=1.0, a=0.0), R_OBS if n_scalars == 2 else 999.0,
        torch.tensor(al), torch.tensor(th), np.pi / 2,
        torch.zeros(N, dtype=torch.bool), 5000.0, steps,
        dynamic_params=dyn, **pkw)
    return ((np.asarray(rj.status), np.asarray(rj.final_alpha)),
            (rp.status.numpy(), rp.final_alpha.numpy()))


@pytest.mark.parametrize("n_scalars", [2, 3])
@pytest.mark.parametrize("form", ["theta", "mu"])
def test_dynamic_trace_matches_pallas_interpret(form, n_scalars):
    (sj, fj), (sp, fp) = _pair(form, n_scalars)
    assert np.array_equal(sj, sp), np.nonzero(sj != sp)[0]
    both = (sj == 1) & (sp == 1)
    assert both.sum() > N // 2
    d = np.abs(fj - fp)[both]
    assert d.max() < TOL[form], (d.max(), np.nonzero(both)[0][d.argmax()])


def test_two_and_three_scalars_agree_at_the_same_radius():
    # r_obs 104 as a Python float (static first step max(1, 1.04)) and as
    # a run-time float32 value: the same rays, the same results
    for form in ("theta", "mu"):
        (s2, f2), (s3, f3) = _pair(form, 2)[1], _pair(form, 3)[1]
        assert np.array_equal(s2, s3)
        assert np.array_equal(np.isnan(f2), np.isnan(f3))


def test_dynamic_hybrid_matches_jax_xla():
    dim = (16, 16)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    al, th = camera.build_angle_lookups_dynamic(dim, fov, 0.0, 0.0,
                                                device="cpu")
    al, th = al.reshape(-1), th.reshape(-1)
    n = al.numel()
    rj = jhybrid(JKerr(M=1.0, a=0.0), 999.0, jnp.asarray(al.numpy()),
                 jnp.asarray(th.numpy()), np.pi / 2, jnp.zeros(n, bool),
                 5000.0, 256, backend="xla",
                 dynamic_params=tuple(jnp.float32(x) for x in DYN[3]))
    before = tk.trace_rays_kerr.launches
    rp = tk.trace_rays_kerr_hybrid(
        Kerr(M=1.0, a=0.0), 999.0, al, th, np.pi / 2,
        torch.zeros(n, dtype=torch.bool), 5000.0, 256, dynamic_params=DYN[3])
    assert tk.trace_rays_kerr.launches - before == 2   # both passes ran
    sj, sp = np.asarray(rj.status), rp.status.numpy()
    assert np.array_equal(sj, sp)
    both = (sj == 1) & (sp == 1)
    d = np.abs(np.asarray(rj.final_alpha) - rp.final_alpha.numpy())[both]
    assert d.max() < TOL["theta"], d.max()
    assert int(rp.n_steps) > 0


def test_dynamic_float64_raises():
    al = torch.full((4,), 0.1, dtype=torch.float64)
    th = torch.zeros(4, dtype=torch.float64)
    ar = torch.zeros(4, dtype=torch.bool)
    args = (Kerr(M=1.0, a=0.0), 100.0, al, th, np.pi / 2, ar, 5000.0, 100)
    for fn in (tk.trace_rays_kerr, tk.trace_rays_kerr_hybrid,
               kk.trace_rays_kerr_cuda, kk.trace_rays_kerr_hybrid,
               kk.trace_rays_kerr_two_pass):
        for dyn in DYN.values():
            with pytest.raises(ValueError, match="float32"):
                fn(*args, dynamic_params=dyn)
    with pytest.raises(ValueError, match="float32-only"):
        jpallas(JKerr(M=1.0, a=0.0), 100.0, jnp.asarray(al.numpy()),
                jnp.asarray(th.numpy()), np.pi / 2, jnp.zeros(4, bool),
                5000.0, 100, interpret=True,
                dynamic_params=(jnp.float32(1.0), jnp.float32(0.9)))
