#!/usr/bin/env python3
"""The plain-PyTorch loops of the 8-D recorder, the fixed-step RK4 tracer,
the adaptive loop of a CustomMetric and the kernels' plain versions (the
extras forms, the Kerr shadow in theta and mu) on one NVIDIA GPU, with
their blocks of steps replayed as CUDA graphs (ops/graphs.py) and run
eagerly: bitwise the same results, and the time of each. Exits 1 if a
plain version is not bitwise its eager run.

  python3 scripts/torch_probe29.py
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def wall(fn, reps=1):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, out


class eager:
    """Within: every step_blocks call of the loops runs eagerly."""

    def __enter__(self):
        from light_path_tracer_tpu_torch import trajectory
        from light_path_tracer_tpu_torch.ops import graphs, kerr_rk4
        from light_path_tracer_tpu_torch.ops import kerr_trace
        self.mods = (trajectory, kerr_rk4, kerr_trace)

        def no_graph(*a, **kw):
            kw["graph"] = False
            return graphs.step_blocks(*a, **kw)
        for m in self.mods:
            m.step_blocks = no_graph

    def __exit__(self, *exc):
        from light_path_tracer_tpu_torch.ops import graphs
        for m in self.mods:
            m.step_blocks = graphs.step_blocks


def same(a, b):
    """Two results (tensors, or tuples and lists of them) bitwise equal,
    NaN equal to NaN."""
    import torch
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if not isinstance(a, torch.Tensor):
        return a == b
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


if __name__ == "__main__":
    import numpy as np
    import torch
    import chip_smoke as cs
    from light_path_tracer_tpu_torch import particles as pt
    from light_path_tracer_tpu_torch.models import (Kerr, Schwarzschild,
                                                    load_user_metric)
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.kerr_rk4 import trace_rays_kerr_rk4
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    out = {}

    def show():
        print(json.dumps(out), flush=True)

    for name, m in (("schwarzschild", Schwarzschild(M=1.0)),
                    ("kerr", Kerr(M=1.0, a=0.9))):
        E, L = pt.orbit_from_apsides(m, 8.0, 16.0)
        s8, _ = pt.timelike_initial_conditions(
            m, torch.tensor(8.0, dtype=torch.float64, device=dev), E, L)
        with eager():
            te, re = wall(lambda: pt.integrate_orbit(m, s8, n_steps=400))
        tg, rg = wall(lambda: pt.integrate_orbit(m, s8, n_steps=400))
        out[f"orbit {name}"] = dict(eager_ms=te * 1e3 / 400,
                                    graph_ms=tg * 1e3 / 400,
                                    bitwise=same(re, rg))
        tg, rg = wall(lambda: pt.integrate_orbit(m, s8, n_steps=6000))
        out[f"orbit {name}"]["graph_6000_s"] = tg
        out[f"orbit {name}"]["precession"] = list(
            pt.periapsis_precession(rg)[:3])
        show()

    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.pipeline import trace_inputs
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0)
    cfg = RenderConfig()
    m = Kerr(M=1.0, a=0.9)
    for n in (128, 1024):
        dim = (n, n)
        fov = camera.fov_from_vertical(scene.vertical_fov, dim)
        al, th, rf, _rows = trace_inputs(scene, cfg, dim, fov, dev)
        tg, rg = wall(lambda: trace_rays_kerr_rk4(
            m, 100.0, al, th, np.pi / 2, rf, 5000.0, 200000))
        row = dict(graph_s=tg, n_steps=int(rg.n_steps))
        if n == 128:
            with eager():
                te, re = wall(lambda: trace_rays_kerr_rk4(
                    m, 100.0, al, th, np.pi / 2, rf, 5000.0, 200000))
            row.update(eager_s=te, bitwise=same(re, rg))
        out[f"rk4 {n}^2"] = row
        show()

    hay = load_user_metric("examples/user_metric_torch.py:hayward")
    th16 = torch.tensor(np.linspace(0, 2 * np.pi, 16, endpoint=False) + 0.05,
                        dtype=torch.float64, device=dev)
    ac = Schwarzschild(M=1.0).alpha_crit(100.0)
    a16 = torch.full((16,), ac * 0.93, dtype=torch.float64, device=dev)
    z16 = torch.zeros(16, dtype=torch.bool, device=dev)
    with eager():
        te, re = wall(lambda: tk.trace_rays_kerr(hay, 100.0, a16, th16,
                                                 np.pi / 2, z16, 5000.0,
                                                 60000))
    tg, rg = wall(lambda: tk.trace_rays_kerr(hay, 100.0, a16, th16,
                                             np.pi / 2, z16, 5000.0, 60000))
    out["custom 16 rays"] = dict(eager_s=te, graph_s=tg,
                                 n_steps=int(rg.n_steps), bitwise=same(re, rg))
    show()
    tg, acg = wall(lambda: hay.alpha_crit(100.0))
    out["custom alpha_crit"] = dict(s=tg, value=acg)
    show()
    from light_path_tracer_tpu_torch.pipeline import render_shadow
    hs = SceneConfig(M=1.0, a=0.0, r_obs_mult=100.0, custom_metric=hay)
    for n in (64, 512):
        probe = {}
        tg, (img, st) = wall(lambda: render_shadow(hs, (n, n), cfg,
                                                   device="cuda"))
        out[f"hayward {n}^2"] = dict(s=tg, steps=int(st["integrator_steps"]),
                                     dark=int((img == 0).sum()))
        show()
    # The kernels' plain versions on the card: every extras form of
    # phases 11 and 14 and the Kerr shadow (theta DP45 and DOP853, the mu
    # hybrid), eager against replayed, on 1,024 of phase 11's rays
    # capped at 300 attempts.
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kerr = Kerr(M=1.0, a=0.9)
    rng = np.random.default_rng(0)
    R_OBS = 100.0
    ac = kerr.alpha_crit(R_OBS, cs.THETA_VOL)
    f32 = dict(dtype=torch.float32, device=dev)
    al = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, 1024), **f32)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, 1024), **f32)
    ref = torch.zeros(1024, dtype=torch.bool, device=dev)
    runs = {}
    for label, (riaf, freqs) in cs.volumetric_forms().items():
        runs[label] = (lambda riaf=riaf, freqs=freqs: cs.extras_trace(
            kerr, riaf, freqs, al, th, 300, False, sat_window=64)[0])
    for label, form in cs.aux_forms(kerr, al, th).items():
        runs[label] = (lambda form=form: cs.aux_trace(
            kerr, form, al, th, 300, False, sat_window=64))
    for method in ("dp45", "dop853"):
        runs[f"kerr theta {method}"] = (lambda method=method: kk.
                                        trace_rays_kerr_plain(
                                            kerr, R_OBS, al, th, np.pi / 2,
                                            ref, 5000.0, 300,
                                            method=method))
    runs["kerr mu hybrid"] = lambda: kk.trace_rays_kerr_hybrid(
        kerr, R_OBS, al, th, np.pi / 2, ref, 5000.0, 300, pass1_steps=300,
        trace_fn=kk.trace_rays_kerr_plain)
    plain = {}
    for label, run in runs.items():
        tg, rg = wall(run)
        with eager():
            te, re = wall(run)
        plain[label] = dict(eager_s=te, graph_s=tg, bitwise=same(rg, re))
        print(json.dumps({label: plain[label]}), flush=True)
    out["plain versions"] = plain
    show()
    ok = all(v["bitwise"] for v in plain.values())
    print(f"every plain version bitwise replayed: {ok}", flush=True)
    sys.exit(0 if ok else 1)
