"""The port's lens-map functions on the same inputs as the JAX package's
(render.escape_directions, _source_plane_coords, magnification_map,
world_escape_beta, image_gnomonic_grids, lens_jacobian_decomposition,
fermat_tau, source_plane_map, microlens_light_curve), the spherical
scenes' route to the 5-D tracer, the `mesh=` refusals, the colour
tables and the `lens` CLI's map modes.

Scene and packages as tests/test_torch_lens_maps.py's (Kerr a = 0.9 at
r_obs = 50 M, 30 deg vertical FOV, seen from 80 deg, 32^2). Criteria:
  * the map functions on the same inputs (JAX's float64 surface trace
    and precompute, into both packages): float64 outputs within 1e-12
    of the largest value (the float32 magnification, caustic and
    microlens outputs within 1e-6, the shear maps 1e-10);
    torch.gradient equals jnp.gradient bitwise on a grid, edges
    included;
  * a Schwarzschild scene's float64 arrival-time map (traced as Kerr at
    a = 0) equals JAX's to 1e-9;
  * the CLI modes at 32^2 write their files and print JAX's lines.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import camera as jcamera
from light_path_tracer_tpu import pipeline as jpipe
from light_path_tracer_tpu import render as jrender
from light_path_tracer_tpu.ops.kerr_trace import ESCAPED
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import camera, pipeline, render
from light_path_tracer_tpu_torch.convert import (metric_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import (Kerr, KerrNewman,
                                                ReissnerNordstrom,
                                                Schwarzschild)
from light_path_tracer_tpu_torch.utils import save
from light_path_tracer_tpu_torch.utils.color import colormap

from test_torch_lens_maps import DIM, FOV, JS, _np


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(a, b, tol=1e-12):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    ok = np.isfinite(a)
    scale = max(float(np.abs(a[ok]).max()) if ok.any() else 0.0, 1e-300)
    assert float(np.abs(a - b)[ok].max(initial=0.0)) <= tol * scale


def test_gradient_matches_jnp_gradient():
    g = np.random.default_rng(0).standard_normal((7, 9))
    for j, t in zip(jnp.gradient(jnp.asarray(g)),
                    torch.gradient(torch.tensor(g))):
        assert np.array_equal(np.asarray(j), t.numpy())


@functools.lru_cache(maxsize=None)
def _jax_surface():
    metric = jpipe._metric_5d(JS.metric())
    al = jcamera.build_alpha_lookup(DIM, FOV, dtype=jnp.float64)
    th = jcamera.build_theta_lookup(DIM, FOV, dtype=jnp.float64)
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_surface
    res = trace_rays_surface(
        metric, JS.r_obs, al.ravel(), th.ravel(), JS.theta_obs,
        r_surface=float(metric.capture_radius()), lambda_max=5000.0,
        max_steps=20000, record_time=True)
    return metric, {k: np.asarray(v) for k, v in res._asdict().items()}


def test_map_functions_on_the_same_inputs():
    jm, r = _jax_surface()
    tm = metric_from_jax(jm)
    t = {k: torch.tensor(v) for k, v in r.items()}
    esc_j, esc_t = r["status"] == ESCAPED, t["status"] == 1
    r_e = 2.0 * JS.r_obs
    args = ("theta", "phi", "p_r", "p_theta", "xi")
    jb = jrender.world_escape_beta(jm, r_e, *(r[k] for k in args), esc_j,
                                   JS.theta_obs)
    tb = render.world_escape_beta(tm, r_e, *(t[k] for k in args), esc_t,
                                  JS.theta_obs)
    for a, b in zip(jb, tb):
        _close(a, b)
    _close(jrender.fermat_tau(jm, r_e, *(r[k] for k in args), r["t_hit"],
                              esc_j),
           render.fermat_tau(tm, r_e, *(t[k] for k in args), t["t_hit"],
                             esc_t))
    bx, by = (np.asarray(b).reshape(DIM) for b in jb)
    tbx, tby = torch.tensor(bx), torch.tensor(by)
    ja, jext = jrender.source_plane_map(jnp.asarray(bx), jnp.asarray(by),
                                        DIM, FOV, 0.2, bins=24)
    ta, text = render.source_plane_map(tbx, tby, DIM, FOV, 0.2, bins=24)
    assert tuple(jext) == tuple(text) and ta.dtype == torch.float32
    _close(ja, ta, 1e-6)
    track = np.stack([np.linspace(-0.3, 0.3, 21), np.full(21, 0.05)], -1)
    _close(jrender.microlens_light_curve(jnp.asarray(bx), jnp.asarray(by),
                                         DIM, FOV, track, 0.03),
           render.microlens_light_curve(tbx, tby, DIM, FOV, track, 0.03),
           1e-6)
    jx = jrender.image_gnomonic_grids(DIM, FOV, dtype=jnp.float64)
    tx = render.image_gnomonic_grids(DIM, FOV, dtype=torch.float64,
                                     device="cpu")
    for a, b in zip(jx, tx):
        _close(a, b)
    for a, b in zip(jrender.lens_jacobian_decomposition(
            jnp.asarray(bx), jnp.asarray(by), *jx),
            render.lens_jacobian_decomposition(tbx, tby, *tx)):
        _close(a, b, 1e-10)

    # The collapsed chart and the magnification map of one precompute.
    jc = JRender(dtype="float64")
    fa = np.asarray(jpipe.precompute_final_alpha(JS, jc, DIM, FOV)
                    .final_alpha).astype(np.float64)
    th = jcamera.build_theta_lookup(DIM, FOV, dtype=jnp.float64)
    jframe = jcamera.psi_frame(JS.psi)
    tframe = camera.psi_frame(JS.psi)
    tth = torch.tensor(np.asarray(th))
    for a, b in zip(jrender._source_plane_coords(fa, th, jframe),
                    render._source_plane_coords(torch.tensor(fa), tth,
                                                tframe)):
        _close(a, b)
    _close(jrender.magnification_map(jnp.asarray(fa), th, jframe, DIM, FOV),
           render.magnification_map(torch.tensor(fa), tth, tframe, DIM,
                                    FOV), 1e-6)


def test_spherical_scene_traces_at_a_zero():
    """A spherically symmetric scene's surface modes trace Kerr or
    Kerr-Newman at a = 0 (pipeline._metric_5d), as the JAX package's do;
    the Schwarzschild arrival-time map equals JAX's."""
    assert pipeline._metric_5d(Schwarzschild(M=2.0)) == Kerr(M=2.0, a=0.0)
    assert pipeline._metric_5d(ReissnerNordstrom(M=1.0, Q=0.5)) == \
        KerrNewman(M=1.0, a=0.0, Q=0.5)
    k = Kerr(M=1.0, a=0.5)
    assert pipeline._metric_5d(k) is k
    js = JScene(M=1.0, r_obs_mult=30.0, vertical_fov_deg=40.0)
    jtau, _ = jpipe.render_time_delay(js, (20, 20))
    ttau, _ = pipeline.render_time_delay(scene_from_jax(js), (20, 20),
                                         device="cpu")
    ok = np.isfinite(np.asarray(jtau))
    assert np.array_equal(ok, np.isfinite(ttau.numpy()))
    assert np.allclose(np.asarray(jtau)[ok], ttau.numpy()[ok], rtol=1e-9,
                       atol=1e-9)


@pytest.mark.parametrize("fn", ["render_caustics", "render_microlens_curve",
                                "render_time_delay", "render_shear"])
def test_mesh_is_not_ported(fn):
    with pytest.raises(NotImplementedError, match="mesh"):
        getattr(pipeline, fn)(scene_from_jax(JS), DIM, mesh=object(),
                              device="cpu")


def test_colormap_tables():
    for name in ("RdBu_r", "viridis", "inferno"):
        rgb = colormap(name, np.array([-1.0, 0.0, 0.5, 1.0, 2.0]))
        assert rgb.shape == (5, 3) and (rgb >= 0).all() and (rgb <= 1).all()
        assert np.array_equal(rgb[0], rgb[1]) and np.array_equal(rgb[3],
                                                                 rgb[4])
    # RdBu_r: blue at 0, near-white in the middle, red at 1.
    lo, mid, hi = colormap("RdBu_r", [0.0, 0.5, 1.0])
    assert lo[2] > lo[0] and hi[0] > hi[2] and mid.min() > 0.9
    with pytest.raises(ValueError):
        colormap("jet", 0.5)


@pytest.mark.parametrize("flags,lines,files", [
    (["--magnification", "{}/m.png"],
     ["Magnification map 32x32: |mu|_max=", "odd-parity px"], ["m.png"]),
    (["--shear", "{}/s.png"], ["Shear decomposition 32x32: gamma_max="],
     ["s_kappa.png", "s_gamma.png", "s_gamma1.png", "s_omega.png",
      "s.npz"]),
    (["--caustics", "{}/c.png", "--caustic-bins", "24"],
     ["Caustic map 24x24 (traced 32x32, beta_max 10.50 deg): A_max="],
     ["c.png"]),
    (["--time-delay", "{}/t.png", "--dtype", "float64"],
     ["Arrival-time map 32x32: tau_max="], ["t.png"]),
    (["--microlens", "{}/ml.png", "--track-points", "9"],
     ["Microlensing curve (9 points, impact u0=1.0, source radius 0.3 "
      "theta_E, theta_E = 16.206 deg): A_peak="], ["ml.csv"]),
    (["--microlens", "{}/ml.csv", "--track-points", "9"],
     ["Microlensing curve (9 points"], ["ml.csv"])])
def test_cli_lens_map_modes(tmp_path, capsys, flags, lines, files):
    from light_path_tracer_tpu_torch.cli import main
    flags = [f.format(tmp_path) for f in flags]
    assert main(["lens", *flags, "--size", "32", "--a", "0.9", "--fov-v",
                 "30", "--r-obs", "50", "--theta-obs", "80",
                 "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Metric: Kerr (M=1.0, a=0.9)" in text
    for line in lines:
        assert line in text
    for name in files:
        path = tmp_path / name
        assert f"Saved: {path}" in text
        if name.endswith(".png"):
            assert save.read_png(path).shape == (*(
                (24, 24) if name == "c.png" else DIM), 3)
        elif name.endswith(".npz"):
            with np.load(path) as z:
                assert sorted(z.files) == ["gamma", "gamma1", "gamma2",
                                           "kappa", "omega"]
        else:
            rows = path.read_text().splitlines()
            assert rows[0] == "track_pos_thetaE,u,A" and len(rows) == 10
