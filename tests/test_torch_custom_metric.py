"""The port's user-defined metrics (models/custom.py, examples/
user_metric_torch.py, --metric-py) against the JAX package's.

Inputs: fans of rays made from a numpy seed (alpha uniform in
[0.02, 0.25] rad, theta uniform) at r_obs = 100 M (60 M for the binary
and the wormhole, as their examples recommend); both packages trace on
the CPU in float64 through their plain / XLA adaptive loops, each side
from its own covariant function (torch here, jax.numpy there). Criteria:
  * the closure identity: CustomMetric(kerr_covariant(1, 0.7)) traces
    like the port's Kerr(1, 0.7) on 48 rays: equal statuses, final alpha
    within 1e-9;
  * each example of examples/user_metric_torch.py (hayward,
    rotating_hayward at a = 0.9, ellis_wormhole, mp_binary) against the
    same example of examples/user_metric.py on a 16-ray fan, max_steps
    800 (the binary's throat-bound rays run to the cap, ~13 ms an attempt
    on the CPU): equal capture radius (1e-12) and statuses, final alpha
    within 1e-9;
  * the critical angle by bisection (2 azimuths, 6 halvings) equal to
    JAX's; the override and the per-instance cache;
  * the loader's errors; SceneConfig.metric, convert.scene_from_jax, the
    kernel's family check and trace_batch's backend="cuda" refusal; the
    CLI's --metric-py acceptance (shadow, ray) and its rejections.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu.models import CustomMetric as JCustom
from light_path_tracer_tpu.models import load_user_metric as jload
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr as jtrace
from light_path_tracer_tpu_torch.models import (CustomMetric, Kerr,
                                                kerr_covariant,
                                                load_covariant_fn,
                                                load_user_metric,
                                                reissner_nordstrom_covariant)
from light_path_tracer_tpu_torch.ops import kerr_trace as tkt

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, os.pardir, "examples")
TORCH_EX = os.path.join(EXAMPLES, "user_metric_torch.py")
JAX_EX = os.path.join(EXAMPLES, "user_metric.py")
CASES = {"hayward": (0.0, 100.0), "rotating_hayward": (0.9, 100.0),
         "ellis_wormhole": (0.0, 60.0), "mp_binary": (0.0, 60.0)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fan(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.02, 0.25, n), rng.uniform(-np.pi, np.pi, n)


def _port(metric, al, th, r_obs=100.0, max_steps=4000):
    res = tkt.trace_rays_kerr(metric, r_obs, torch.tensor(al),
                              torch.tensor(th), np.pi / 2,
                              torch.zeros(len(al), dtype=torch.bool),
                              5000.0, max_steps)
    return res.status.numpy(), res.final_alpha.numpy()


def _jax(metric, al, th, r_obs=100.0, max_steps=4000):
    with jax.enable_x64(True):
        res = jtrace(metric, r_obs, jnp.asarray(al), jnp.asarray(th),
                     np.pi / 2, jnp.zeros(len(al), bool), 5000.0, max_steps)
        return np.asarray(res.status), np.asarray(res.final_alpha)


def test_kerr_closure_identity():
    al, th = _fan(48)
    cm = CustomMetric(M=1.0, a=0.7, covariant_fn=kerr_covariant(1.0, 0.7))
    assert 1.01 * Kerr(M=1.0, a=0.7).r_plus <= cm.capture_radius() \
        <= 1.05 * Kerr(M=1.0, a=0.7).r_plus
    sk, fk = _port(Kerr(M=1.0, a=0.7), al, th, max_steps=60000)
    sc, fc = _port(cm, al, th, max_steps=60000)
    np.testing.assert_array_equal(sk, sc)
    esc = sk == 1
    assert esc.sum() >= 10
    np.testing.assert_allclose(fc[esc], fk[esc], rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", CASES)
def test_examples_match_jax(name):
    a, r_obs = CASES[name]
    tm = load_user_metric(f"{TORCH_EX}:{name}", M=1.0, a=a)
    jm = jload(f"{JAX_EX}:{name}", M=1.0, a=a)
    assert isinstance(tm, CustomMetric) and isinstance(jm, JCustom)
    assert tm.capture_radius() == pytest.approx(jm.capture_radius(),
                                                rel=1e-12)
    al, th = _fan(16, seed=1)
    sg, fg = _port(tm, al, th, r_obs, max_steps=800)
    sw, fw = _jax(jm, al, th, r_obs, max_steps=800)
    np.testing.assert_array_equal(sg, sw)
    esc = sw == 1
    assert esc.any()
    np.testing.assert_allclose(fg[esc], fw[esc], rtol=0, atol=1e-9)


def test_alpha_crit_bisection_matches_jax():
    rn_t = CustomMetric(M=1.0, a=0.0,
                        covariant_fn=reissner_nordstrom_covariant(1.0, 0.6))
    from light_path_tracer_tpu.models import (
        reissner_nordstrom_covariant as jrn)
    rn_j = JCustom(M=1.0, a=0.0, covariant_fn=jrn(1.0, 0.6))
    kw = dict(n_azimuth=2, iters=6, max_steps=4000)
    got = rn_t.alpha_crit(100.0, device="cpu", **kw)
    with jax.enable_x64(True):
        want = rn_j.alpha_crit(100.0, **kw)
    assert got == want
    # Kept for the instance's next call with the same arguments.
    assert rn_t.alpha_crit(100.0, device="cpu", **kw) == got
    assert len(rn_t._alpha_crit) == 1
    mp = load_user_metric(f"{TORCH_EX}:mp_binary")
    assert mp.alpha_crit(60.0) == pytest.approx(8.0 / 60.0)


def test_loader_and_validation_errors(tmp_path):
    with pytest.raises(ValueError):
        load_covariant_fn("no_colon.py")
    with pytest.raises(FileNotFoundError):
        load_covariant_fn("/does/not/exist.py:fn")
    bad = tmp_path / "bad.py"
    bad.write_text("not_callable = 3\n")
    with pytest.raises(TypeError):
        load_covariant_fn(str(bad) + ":not_callable")
    with pytest.raises(TypeError):
        load_user_metric(str(bad) + ":not_callable")
    flat = kerr_covariant(1e-12, 0.0)
    assert CustomMetric(M=1.0, a=0.0, covariant_fn=flat,
                        capture_radius_override=3.0).capture_radius() == 3.0
    with pytest.raises(ValueError):
        CustomMetric(M=1.0, a=0.0)
    with pytest.raises(ValueError):
        CustomMetric(M=1.0, a=0.0, covariant_fn=flat,
                     capture_radius_override=-1.0)
    with pytest.raises(NotImplementedError):
        CustomMetric(M=1.0, a=0.0, covariant_fn=flat).rhs5_mu(
            (torch.ones(2),) * 5, torch.ones(2), torch.ones(2))


def test_scene_routes_and_refusals():
    from light_path_tracer_tpu.utils.config import SceneConfig as JScene
    from light_path_tracer_tpu_torch.convert import scene_from_jax
    from light_path_tracer_tpu_torch.ops.batch import trace_batch
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    cm = CustomMetric(M=1.0, a=0.3, covariant_fn=kerr_covariant(1.0, 0.3))
    scene = SceneConfig(M=1.0, a=0.3, custom_metric=cm)
    assert scene.metric() is cm
    hash(scene)
    with pytest.raises(ValueError, match="jax.numpy"):
        scene_from_jax(JScene(custom_metric=jload(f"{JAX_EX}:mp_binary")))
    with pytest.raises(TypeError):
        kk.metric_family(cm)
    al = torch.full((4,), 0.1, dtype=torch.float64)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        trace_batch(cm, 100.0, al, backend="cuda")
    n0 = tkt.trace_rays_kerr.launches
    res = trace_batch(cm, 100.0, al, max_steps=500)
    assert tkt.trace_rays_kerr.launches == n0 + 1
    assert res.status.shape == (4,)
    with pytest.raises(NotImplementedError):
        trace_batch(cm, 100.0, al, formulation="mu", max_steps=100)


def test_cli_metric_py(tmp_path, monkeypatch, capsys):
    from light_path_tracer_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    spec = os.path.abspath(TORCH_EX)
    rc = main(["shadow", "--size", "8", "--r-obs", "60", "--fov-v", "20",
               "--max-steps", "300", "--metric-py", spec + ":mp_binary",
               "--device", "cpu", "--output", "mp.png"])
    assert rc == 0 and os.path.exists("mp.png")
    rc = main(["ray", "--no-plot", "--alpha-deg", "10", "--metric-py",
               spec + ":hayward", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Metric:             CustomMetric" in out
    assert "ESCAPED" in out
    for mode in ("disk", "volumetric", "star", "animate"):
        rc = main([mode, "--size", "8", "--metric-py", spec + ":hayward",
                   "--device", "cpu", "--output", "x.png"])
        assert rc == 2, mode
        assert "not supported in " + mode in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["shadow", "--size", "8", "--Q", "0.5", "--metric-py",
              spec + ":hayward", "--device", "cpu", "--output", "h.png"])
