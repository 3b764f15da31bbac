"""The port's fixed-step RK4 tracer (ops/kerr_rk4.py) against the JAX
package's `trace_rays_kerr_rk4`, and its route through `trace_batch`.

Inputs: 40 rays made from a numpy seed, half inside (0.3-0.8 alpha_crit)
and half outside (1.2-4 alpha_crit) the shadow, theta uniform, 30 % of
them axis-refined, at r_obs = 100 M; Kerr a = 0.9, Kerr-Newman (a 0.6,
Q 0.6) and Johannsen-Psaltis (a 0.9, eps3 2). Both packages trace on the
CPU. Criteria:
  * float64: equal status, winding and n_steps (the loop's iteration
    count, which stops on the step where no lane runs), final alpha
    within 1e-10;
  * float32 (Kerr): equal status and n_steps, final alpha within 1e-4;
  * trace_batch(integrator="rk4") returns the tracer's result whole and
    in chunks (the chunked branch sums the chunks' counts); the shadow
    render takes it through RenderConfig(integrator="rk4");
  * the adaptive loops and the CUDA kernel wrappers refuse "rk4" with a
    ValueError naming the fixed-step tracer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu.models import JohannsenPsaltis as JJP
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models import KerrNewman as JKN
from light_path_tracer_tpu.ops.kerr_rk4 import trace_rays_kerr_rk4 as jrk4
from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman)
from light_path_tracer_tpu_torch.ops import kerr_trace as tkt
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
from light_path_tracer_tpu_torch.ops.kerr_rk4 import trace_rays_kerr_rk4

R_OBS = 100.0
FAMILIES = {
    "kerr": (JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)),
    "kerr_newman": (JKN(M=1.0, a=0.6, Q=0.6), KerrNewman(M=1.0, a=0.6,
                                                         Q=0.6)),
    "johannsen_psaltis": (JJP(M=1.0, a=0.9, eps3=2.0),
                          JohannsenPsaltis(M=1.0, a=0.9, eps3=2.0)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rays(metric, n=40, seed=9):
    ac = metric.alpha_crit(R_OBS)
    rng = np.random.default_rng(seed)
    al = np.concatenate([rng.uniform(0.3 * ac, 0.8 * ac, n // 2),
                         rng.uniform(1.2 * ac, 4.0 * ac, n // 2)])
    return al, rng.uniform(-np.pi, np.pi, n), rng.random(n) < 0.3


def _both(family, dtype):
    jm, tm = FAMILIES[family]
    al, th, ref = _rays(JKerr(M=1.0, a=0.9))
    with jax.enable_x64(dtype == "float64"):
        want = jrk4(jm, R_OBS, jnp.asarray(al, dtype),
                    jnp.asarray(th, dtype), np.pi / 2, jnp.asarray(ref),
                    5000.0, 200000)
        want = [np.asarray(x) for x in want]
    td = getattr(torch, dtype)
    got = trace_rays_kerr_rk4(tm, R_OBS, torch.tensor(al, dtype=td),
                              torch.tensor(th, dtype=td), np.pi / 2,
                              torch.tensor(ref), 5000.0, 200000)
    return want, got


@pytest.mark.parametrize("family", FAMILIES)
def test_rk4_float64_matches_jax(family):
    want, got = _both(family, "float64")
    np.testing.assert_array_equal(got.status.numpy(), want[2])
    np.testing.assert_array_equal(got.n_half_orbits.numpy(), want[1])
    assert int(got.n_steps) == int(want[3])
    esc = want[2] == 1
    assert esc.sum() >= 10 and (want[2] == -1).sum() >= 10
    np.testing.assert_allclose(got.final_alpha.numpy()[esc], want[0][esc],
                               rtol=0, atol=1e-10)
    assert np.isnan(got.final_alpha.numpy()[~esc]).all()


def test_rk4_float32_matches_jax():
    want, got = _both("kerr", "float32")
    np.testing.assert_array_equal(got.status.numpy(), want[2])
    assert int(got.n_steps) == int(want[3])
    esc = want[2] == 1
    np.testing.assert_allclose(got.final_alpha.numpy()[esc], want[0][esc],
                               rtol=0, atol=1e-4)


def test_trace_batch_routes_rk4_whole_and_chunked():
    tm = Kerr(M=1.0, a=0.9)
    al, th, ref = _rays(tm)
    args = (tm, R_OBS, torch.tensor(al), torch.tensor(th), np.pi / 2,
            torch.tensor(ref))
    direct = trace_rays_kerr_rk4(*args, 5000.0, 200000)
    n0 = trace_rays_kerr_rk4.launches
    whole = trace_batch(*args, integrator="rk4")
    assert trace_rays_kerr_rk4.launches == n0 + 1
    for a, b in zip(whole[:3], direct[:3]):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert int(whole.n_steps) == int(direct.n_steps)
    chunked = trace_batch(*args, integrator="rk4", chunk_size=20,
                          sort_by_difficulty=False)
    assert torch.equal(chunked.status, direct.status)
    assert int(chunked.n_steps) >= int(direct.n_steps)


def test_shadow_render_takes_rk4():
    from light_path_tracer_tpu_torch.pipeline import render_shadow
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                        vertical_fov_deg=12.0)
    n0 = trace_rays_kerr_rk4.launches
    img, stats = render_shadow(scene, (16, 16), RenderConfig(
        integrator="rk4"), device="cpu")
    assert trace_rays_kerr_rk4.launches == n0 + 1
    ref, _ = render_shadow(scene, (16, 16), RenderConfig(), device="cpu")
    assert stats["integrator_steps"] > 0
    assert float((img == ref).float().mean()) > 0.95


def test_adaptive_paths_refuse_rk4():
    tm = Kerr(M=1.0, a=0.9)
    al = torch.full((4,), 0.05, dtype=torch.float64)
    ref = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="fixed-step"):
        tkt.trace_rays_kerr(tm, R_OBS, al, al, np.pi / 2, ref, 5000.0, 100,
                            method="rk4")
    with pytest.raises(ValueError, match="fixed-step"):
        kk.method_suffix("rk4")
