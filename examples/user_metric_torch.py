"""Example user-defined spacetimes for the PyTorch package's --metric-py /
CustomMetric, with the constants of examples/user_metric.py.

Each module-level callable follows the plug-in contract
(light_path_tracer_tpu_torch/models/custom.py): (r, th) -> (g_tt, g_tphi,
g_rr, g_thth, g_phiphi), batched torch over same-shape tensors,
parameters closed over. `mp_binary` and `ellis_wormhole` are the instance
form (ready CustomMetric objects). Run e.g.

    python -m light_path_tracer_tpu_torch shadow --size 512 \
        --metric-py examples/user_metric_torch.py:hayward --output hayward.png

    python -m light_path_tracer_tpu_torch shadow --size 512 --a 0.9 \
        --metric-py examples/user_metric_torch.py:rotating_hayward \
        --output rotating_hayward.png

    # two extremal charged holes (throat-bound rays integrate to
    # max_steps before they book as captured)
    python -m light_path_tracer_tpu_torch shadow --size 256 --fov-v 20 \
        --r-obs 60 --max-steps 6000 \
        --metric-py examples/user_metric_torch.py:mp_binary --output mp.png

The Hayward regular black hole (Hayward 2006, PRL 96, 031103) replaces the
singular Schwarzschild core by a de Sitter core of scale l: f(r) = 1 -
2 M r^2 / (r^3 + 2 M l^2). The rotating variant substitutes M -> m(r) =
M r^3 / (r^3 + 2 M l^2) in the Kerr form (Bambi & Modesto 2013).
"""

import torch

M = 1.0        # asymptotic mass: match --M (default 1.0)
A = 0.9        # spin of the rotating example: match --a
L_CORE = 0.9   # de Sitter core scale l in units of M

_SIN2_FLOOR = 1e-15


def _sin2(th):
    return torch.clamp(torch.sin(th) ** 2, min=_SIN2_FLOOR)


def hayward(r, th):
    """Static Hayward regular black hole (l = L_CORE)."""
    sin2 = _sin2(th)
    f = 1.0 - 2.0 * M * r * r / (r ** 3 + 2.0 * M * L_CORE ** 2)
    zero = torch.zeros_like(r * th)
    return (-f + zero, zero, 1.0 / f + zero,
            r * r + zero, r * r * sin2)


def mp_binary_covariant(m1, m2, s):
    """Majumdar-Papapetrou binary: two extremal charged holes at rest on
    the polar axis at z = +-s, in isotropic coordinates ds^2 = -U^-2 dt^2
    + U^2 dx.dx with U = 1 + m1/d1 + m2/d2 (spatial part diagonal in the
    spherical chart). Each horizon is the point d_i = 0."""
    def fn(r, th):
        sin2 = _sin2(th)
        cos_th = torch.cos(th)
        d1 = torch.sqrt(torch.clamp(
            r * r + s * s - 2.0 * r * s * cos_th, min=1e-30))
        d2 = torch.sqrt(torch.clamp(
            r * r + s * s + 2.0 * r * s * cos_th, min=1e-30))
        U = 1.0 + m1 / d1 + m2 / d2
        U2 = U * U
        return (-1.0 / U2, torch.zeros_like(U), U2,
                U2 * r * r, U2 * r * r * sin2)
    return fn


def _mp_captured(m1, m2, s, u_cap=8.0):
    def fn(r, th):
        cos_th = torch.cos(th)
        d1 = torch.sqrt(torch.clamp(
            r * r + s * s - 2.0 * r * s * cos_th, min=1e-30))
        d2 = torch.sqrt(torch.clamp(
            r * r + s * s + 2.0 * r * s * cos_th, min=1e-30))
        return (1.0 + m1 / d1 + m2 / d2) > u_cap
    return fn


MP_M1, MP_M2, MP_S = 0.5, 0.5, 6.0


def _make_mp_binary():
    # M = m1 + m2 calibrates the far-field screen; alpha_crit is the
    # outer shadow edge at the recommended r_obs = 60 M, display only.
    from light_path_tracer_tpu_torch.models import CustomMetric
    return CustomMetric(
        M=MP_M1 + MP_M2, a=0.0,
        covariant_fn=mp_binary_covariant(MP_M1, MP_M2, MP_S),
        captured_fn=_mp_captured(MP_M1, MP_M2, MP_S),
        capture_radius_override=0.02,
        alpha_crit_override=(MP_S + 4.0 * MP_M1) / 60.0,
        label=f"MP binary m1={MP_M1} m2={MP_M2} s={MP_S}")


mp_binary = _make_mp_binary()


def ellis_covariant(b):
    """Ellis-Bronnikov massless wormhole in the areal chart r > b:
    ds^2 = -dt^2 + dr^2 / (1 - b^2/r^2) + r^2 dOmega^2. g_rr flips sign
    at the throat, which the signature scan turns into the capture
    surface (1.02 b)."""
    def fn(r, th):
        sin2 = _sin2(th)
        zero = torch.zeros_like(r * th)
        g_rr = 1.0 / (1.0 - (b * b) / (r * r))
        return (-1.0 + zero, zero, g_rr + zero,
                r * r + zero, r * r * sin2)
    return fn


WH_THROAT = 2.0


def _make_ellis():
    from light_path_tracer_tpu_torch.models import CustomMetric
    return CustomMetric(M=0.0, a=0.0,
                        covariant_fn=ellis_covariant(WH_THROAT),
                        label=f"Ellis wormhole b={WH_THROAT}")


ellis_wormhole = _make_ellis()


def rotating_hayward(r, th):
    """Rotating Hayward (spin A, core L_CORE): Kerr with M -> m(r) =
    M r^3 / (r^3 + 2 M l^2)."""
    sin2 = _sin2(th)
    cos_th = torch.cos(th)
    m_r = M * r ** 3 / (r ** 3 + 2.0 * M * L_CORE ** 2)
    Sigma = r * r + A * A * cos_th * cos_th
    Delta = r * r - 2.0 * m_r * r + A * A
    two_mr = 2.0 * m_r * r
    g_tt = -(1.0 - two_mr / Sigma)
    g_tphi = -A * two_mr * sin2 / Sigma
    g_rr = Sigma / Delta
    g_thth = Sigma
    g_phiphi = (r * r + A * A + A * A * two_mr * sin2 / Sigma) * sin2
    return g_tt, g_tphi, g_rr, g_thth, g_phiphi
