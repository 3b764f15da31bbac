"""The port's timelike orbits (light_path_tracer_tpu_torch/particles.py)
against the JAX package's, and on the physics oracles of
tests/test_particles.py.

Inputs: Schwarzschild and Kerr (a 0, 0.7, 0.9) with the orbits of
tests/test_particles.py; both packages on the CPU in float64. Criteria:
  * circular_orbit, orbit_from_apsides, timelike_initial_conditions and
    hamiltonian within 1e-10 relative of JAX's;
  * the diagnostics (apsis_passages, periapsis_precession,
    nodal_precession) on the same recorded path (JAX's) within 1e-10;
  * the port's own integrated orbits give JAX's periapsis advance within
    1e-7 rad (the recorders' step sizes part at ~1e-8 relative, see
    tests/test_torch_trajectory.py);
  * the oracles at tests/test_particles.py's bars, with step budgets cut
    to what each needs (two periapsis passages, two ascending nodes, two
    revolutions) so that the file stays under a minute: a circular orbit
    stays circular at the BPT Omega; H is conserved to 1e-8; the
    Schwarzschild advance equals the exact quadrature to 2e-3; prograde
    spin reduces and retrograde increases it (each to 2e-3 of its
    quadrature, the half-difference to 30 % of 8 pi a sqrt(M) / p^1.5);
    Kerr a = 0 equals Schwarzschild; the Lense-Thirring node drift is
    within 25 % of 4 pi a sqrt(M) / r^1.5; a start below the ISCO
    plunges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import particles as jp
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models import Schwarzschild as JS
from light_path_tracer_tpu_torch import particles as pt
from light_path_tracer_tpu_torch.models import Kerr, Schwarzschild
from light_path_tracer_tpu_torch.trajectory import Trajectory

from test_particles import (_kerr_equatorial_exact_advance,
                            _schwarzschild_exact_advance)

M = 1.0
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(a):
    if a is None:
        return JS(M), Schwarzschild(M)
    return JKerr(M, a), Kerr(M, a)


def _torch_traj(jtraj):
    return Trajectory(*(torch.tensor(np.array(x)) for x in jtraj))


@pytest.mark.parametrize("a", [None, 0.7, 0.9])
def test_integrals_and_initial_conditions_match_jax(a):
    jm, tm = _pair(a)
    for r in (8.0, 10.0, 20.0):
        np.testing.assert_allclose(pt.circular_orbit(tm, r),
                                   jp.circular_orbit(jm, r), rtol=1e-10)
        np.testing.assert_allclose(
            pt.circular_orbit(tm, r, prograde=False),
            jp.circular_orbit(jm, r, prograde=False), rtol=1e-10)
    for rp, ra in ((8.0, 14.0), (10.0, 20.0), (6.5, 30.0)):
        np.testing.assert_allclose(pt.orbit_from_apsides(tm, rp, ra),
                                   jp.orbit_from_apsides(jm, rp, ra),
                                   rtol=1e-10)
    E, L = jp.orbit_from_apsides(jm, 10.0, 20.0)
    r0 = np.array([12.0, 25.0, 8.0])
    ws, wi = jp.timelike_initial_conditions(jm, jnp.asarray(r0), E, L,
                                            p_theta=0.3)
    gs, gi = pt.timelike_initial_conditions(tm, torch.tensor(r0), E, L,
                                            p_theta=0.3)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(pt.hamiltonian(tm, gs).numpy(),
                               np.asarray(jp.hamiltonian(jm, ws)),
                               rtol=1e-10)


@pytest.mark.parametrize("a", [None, 0.9])
def test_diagnostics_and_integrated_orbit_match_jax(a):
    jm, tm = _pair(a)
    E, L = jp.orbit_from_apsides(jm, 8.0, 16.0)
    js8, _ = jp.timelike_initial_conditions(jm, jnp.asarray(8.0), E, L)
    jtraj = jp.integrate_orbit(jm, js8, n_steps=600)
    same = _torch_traj(jtraj)
    for kind in ("peri", "apo"):
        for g, w in zip(pt.apsis_passages(same, kind),
                        jp.apsis_passages(jtraj, kind)):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
    want = jp.periapsis_precession(jtraj)
    np.testing.assert_allclose(pt.periapsis_precession(same), want,
                               rtol=1e-10)
    ts8, _ = pt.timelike_initial_conditions(tm, torch.tensor(8.0, **F64),
                                            E, L)
    traj = pt.integrate_orbit(tm, ts8, n_steps=600)
    assert int(traj.n_valid) == int(jtraj.n_valid)
    got = pt.periapsis_precession(traj)
    assert len(got) == len(want) >= 2
    assert np.max(np.abs(got - want)) < 1e-7


def test_nodal_diagnostic_matches_jax():
    jm = JKerr(M, 0.9)
    E, L, _ = jp.circular_orbit(jm, 20.0)
    inc = 0.15
    js8, _ = jp.timelike_initial_conditions(jm, 20.0, E, L * np.cos(inc),
                                            p_theta=L * np.sin(inc))
    jtraj = jp.integrate_orbit(jm, js8, n_steps=700)
    gd, gl = pt.nodal_precession(_torch_traj(jtraj))
    wd, wl = jp.nodal_precession(jtraj)
    np.testing.assert_allclose(gd, wd, rtol=1e-10)
    np.testing.assert_allclose(gl, wl, rtol=1e-10)


def _orbit(metric, r_p, r_a, n_steps, prograde=True, **ic_kw):
    E, L = pt.orbit_from_apsides(metric, r_p, r_a, prograde=prograde)
    state8, invalid = pt.timelike_initial_conditions(
        metric, torch.tensor(r_p, **F64), E, L, **ic_kw)
    assert not bool(invalid)
    return pt.integrate_orbit(metric, state8, n_steps=n_steps)


def test_circular_orbit_stays_circular_at_bpt_omega():
    k = Kerr(M, 0.9)
    r = 6.0
    E, L, omega = pt.circular_orbit(k, r)
    state8, _ = pt.timelike_initial_conditions(k, torch.tensor(r, **F64),
                                               E, L)
    states, _ = pt._valid_path(pt.integrate_orbit(k, state8, n_steps=300))
    assert states.shape[0] > 100
    assert np.max(np.abs(states[:, 1] - r)) < 1e-6
    t, phi = states[:, 0], np.unwrap(states[:, 3])
    assert t[-1] > 2 * (2 * np.pi / omega)
    assert np.polyfit(t, phi, 1)[0] == pytest.approx(omega, rel=1e-8)


def test_hamiltonian_conserved_along_orbit():
    k = Kerr(M, 0.9)
    states, _ = pt._valid_path(_orbit(k, 4.0, 12.0, 500))
    h = pt.hamiltonian(k, torch.tensor(states)).numpy()
    assert np.max(np.abs(h + 0.5)) < 1e-8


def test_periapsis_precession_schwarzschild():
    r_p, r_a = 40.0, 60.0
    traj = _orbit(Schwarzschild(M), r_p, r_a, 800)
    adv = pt.periapsis_precession(traj)
    assert len(adv) >= 2
    exact = _schwarzschild_exact_advance(r_p, r_a)
    assert np.mean(adv) == pytest.approx(exact, rel=2e-3)
    pred = pt.weak_field_periapsis_advance(M, 0.0, r_p, r_a)
    assert pred < np.mean(adv) < 1.2 * pred
    _, r_peri, _, _ = pt.apsis_passages(traj, "peri")
    _, r_apo, _, _ = pt.apsis_passages(traj, "apo")
    assert np.max(np.abs(r_peri - r_p)) < 1e-2
    assert np.max(np.abs(r_apo - r_a)) < 1e-2


def test_frame_dragging_shifts_periapsis_advance():
    r_p, r_a = 40.0, 60.0
    a = 0.9
    adv, exact = {}, {}
    for key, metric, pro in (("schw", Schwarzschild(M), True),
                             ("pro", Kerr(M, a), True),
                             ("retro", Kerr(M, a), False)):
        E, L = pt.orbit_from_apsides(metric, r_p, r_a, prograde=pro)
        traj = _orbit(metric, r_p, r_a, 800, prograde=pro)
        adv[key] = float(np.mean(pt.periapsis_precession(traj)))
        exact[key] = _kerr_equatorial_exact_advance(
            0.0 if key == "schw" else a, E, L, r_p, r_a)
    assert adv["pro"] < adv["schw"] < adv["retro"]
    for key in adv:
        assert adv[key] == pytest.approx(exact[key], rel=2e-3), key
    p_lat = 2.0 * r_p * r_a / (r_p + r_a)
    spin_term = 8.0 * np.pi * a * np.sqrt(M) / p_lat ** 1.5
    assert 0.5 * (adv["retro"] - adv["pro"]) == pytest.approx(spin_term,
                                                            rel=0.3)


def test_kerr_a0_orbit_matches_schwarzschild():
    s, k = Schwarzschild(M), Kerr(M, 0.0)
    E, L = pt.orbit_from_apsides(s, 8.0, 15.0)
    st_s, _ = pt.timelike_initial_conditions(s, torch.tensor(8.0, **F64),
                                             E, L)
    st_k, _ = pt.timelike_initial_conditions(k, torch.tensor(8.0, **F64),
                                             E, L)
    np.testing.assert_allclose(st_s.numpy(), st_k.numpy(), atol=1e-12)
    ts = pt.integrate_orbit(s, st_s, n_steps=300)
    tk = pt.integrate_orbit(k, st_k, n_steps=300)
    ns, nk = int(ts.n_valid), int(tk.n_valid)
    lam_s, lam_k = ts.lambdas[:ns].numpy(), tk.lambdas[:nk].numpy()
    lam_common = np.linspace(0, min(lam_s[-1], lam_k[-1]), 200)
    for col in (1, 2, 3):
        vs = np.interp(lam_common, lam_s, ts.states[:ns, col].numpy())
        vk = np.interp(lam_common, lam_k, tk.states[:nk, col].numpy())
        np.testing.assert_allclose(vs, vk, atol=5e-7)
    assert min(ns, nk) > 100


def test_nodal_precession_lense_thirring():
    a, r = 0.9, 20.0
    k = Kerr(M, a)
    E, L, _ = pt.circular_orbit(k, r)
    inc = 0.15
    state8, invalid = pt.timelike_initial_conditions(
        k, torch.tensor(r, **F64), E, L * np.cos(inc),
        p_theta=L * np.sin(inc))
    assert not bool(invalid)
    drift, _ = pt.nodal_precession(pt.integrate_orbit(k, state8,
                                                      n_steps=900))
    assert len(drift) >= 2
    pred = 4.0 * np.pi * a * np.sqrt(M) / r ** 1.5
    assert np.all(drift > 0)
    assert np.mean(drift) == pytest.approx(pred, rel=0.25)


def test_plunge_below_isco_is_captured():
    s = Schwarzschild(M)
    E, L, _ = pt.circular_orbit(s, 4.5)
    state8, _ = pt.timelike_initial_conditions(
        s, torch.tensor(4.4, **F64), E, L, outward=False)
    assert int(pt.integrate_orbit(s, state8, n_steps=600).outcome) == -1
    traj2 = _orbit(s, 8.0, 15.0, 300)
    states, _ = pt._valid_path(traj2)
    assert int(traj2.outcome) != -1
    assert np.all(states[:, 1] > 6.0)
