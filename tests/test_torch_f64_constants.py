"""float64 kernel constants, carried from the JAX package unrounded.

The JAX package's configurations (a metric, a RIAFConfig with spectral,
movie, order and jet settings, a polarization field) go through
`convert.py` into the port, which forms each transfer constant in double
(`KernelTransfer.constants`) and packs it for the kernels: `riaf_params`
rounds each once to float32 for the float32 instances and passes it
unrounded to the float64 ones (`RiafParams64`); the orbit kernel's
constants alike. Each float64 value must equal, bitwise, the double the
JAX package's closures form from the same configuration.
"""

import dataclasses
import math

import numpy as np
import torch

from light_path_tracer_tpu import volumetric as jvol
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models import ReissnerNordstrom as JRN
from light_path_tracer_tpu_torch import polarization, volumetric
from light_path_tracer_tpu_torch.convert import (metric_from_jax,
                                                 riaf_config_from_jax)
from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel as sk
from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk

F64 = torch.float64
FREQS = (0.1, 1.3, 10.0)


def _jax_side():
    jm = JKerr(M=1.7, a=0.83)
    jriaf = jvol.RIAFConfig(profile="jet", sigma_r=1.3, h_cos=0.35,
                            jet_sigma=0.07, jet_beta=0.6, g_power=4.0,
                            alpha0=0.7, opacity_index=3.0, spot_amp=3.5,
                            spot_r=7.3, spot_sigma=1.1, spot_phase=0.4,
                            prograde=False)
    return jm, jriaf


def _exact(got, want):
    """Bitwise equality of two doubles."""
    return np.float64(got).tobytes() == np.float64(want).tobytes()


def test_spectral_constants_unrounded_in_float64():
    jm, jriaf = _jax_side()
    m, riaf = metric_from_jax(jm), riaf_config_from_jax(jriaf)
    spec = volumetric.make_spectral_transfer(m, riaf, FREQS).kernel
    p64, p32 = vk.riaf_params(spec, F64), vk.riaf_params(spec)
    assert isinstance(p64, vk.RiafParams64)
    M, a = float(jm.M), float(jm.a)
    s, q = jriaf.g_power - 3.0, jriaf.opacity_index
    c = [float(f) ** (1.0 - q) for f in FREQS]
    want = dict(
        two_M=2.0 * M, a=a, a2=a * a, kep_num=-math.sqrt(M),
        kep_add=-(a * math.sqrt(M)), two_sig_r2=2.0 * jriaf.sigma_r ** 2,
        two_h2=2.0 * jriaf.h_cos ** 2, two_jet_sig2=2.0 * jriaf.jet_sigma ** 2,
        jet_gamma=float(1.0 / np.sqrt(max(1.0 - 0.6 * 0.6, 1e-12))),
        alpha0=jriaf.alpha0, q_minus_1=q - 1.0,
        tau_floor=-30.0 / max(max(c), 1.0))
    for name, value in want.items():
        assert _exact(getattr(p64, name), value), name
    assert all(_exact(x, -ci) for x, ci in zip(p64.neg_c, c))
    assert all(_exact(x, float(f) ** (-s))
               for x, f in zip(p64.band_scale, FREQS))
    # The float32 instances get the same values rounded once.
    rounded = [n for n in want if getattr(p32, n) != getattr(p64, n)]
    assert all(getattr(p32, n) == np.float32(getattr(p64, n))
               for n in want)
    assert len(rounded) >= 6


def test_movie_and_order_constants_unrounded_in_float64():
    jm, jriaf = _jax_side()
    m, riaf = metric_from_jax(jm), riaf_config_from_jax(jriaf)
    times = (0.3, 17.1, 40.7)
    movie = vk.riaf_params(
        volumetric.make_movie_transfer(m, riaf, times).kernel, F64)
    omega = float(jvol.keplerian_omega(float(jm.M), float(jm.a),
                                       jriaf.spot_r, jriaf.prograde))
    assert _exact(movie.spot_omega, omega)
    assert float(np.float32(movie.spot_omega)) != movie.spot_omega
    assert _exact(movie.spot_r2, jriaf.spot_r * jriaf.spot_r)
    assert _exact(movie.two_spot_sig2, 2.0 * jriaf.spot_sigma ** 2)
    assert _exact(movie.spot_phase, 0.4) and _exact(movie.spot_amp, 3.5)
    assert all(_exact(x, t) for x, t in zip(movie.times, times))
    order = vk.riaf_params(
        volumetric.make_order_transfer(m, riaf, 3).kernel, F64)
    sigma = jvol._ORDER_SIGMA
    assert _exact(order.order_norm,
                  float(1.0 / (sigma * np.sqrt(2.0 * np.pi))))
    assert _exact(order.order_inv_two_sig2, float(1.0 / (2.0 * sigma ** 2)))


def test_stokes_constants_unrounded_in_float64():
    jm, jriaf = _jax_side()
    m = metric_from_jax(jm)
    riaf = riaf_config_from_jax(dataclasses.replace(jriaf, alpha0=0.0))
    spec = polarization.make_polarized_volumetric_transfer(
        m, riaf, "toroidal", 0.65).kernel
    p = vk.riaf_params(spec, F64)
    M, a = float(jm.M), float(jm.a)
    assert p.field == 1 and _exact(p.p0, 0.65) and p.flow_sign == -1.0
    assert _exact(p.two_Ma, 2.0 * M * a)
    assert _exact(p.two_Ma2, 2.0 * M * a * a)
    assert float(np.float32(p.two_Ma2)) != p.two_Ma2


def test_orbit_constants_unrounded_in_float64():
    jm = JRN(M=1.3, Q=0.45)
    m = metric_from_jax(jm)
    r_obs = 100.0 * 1.3
    k64 = sk._kernel_constants(m, r_obs, 50.0, 0.05, F64)
    k32 = sk._kernel_constants(m, r_obs, 50.0, 0.05, torch.float32)
    M, Q = float(jm.M), float(jm.Q)
    # (r_obs, sqrt f0, 1 / r_obs, 2 M, Q^2, 3 M, 2 Q^2, u_capture, ...)
    assert _exact(k64[3], 2.0 * M) and _exact(k64[4], Q * Q)
    assert _exact(k64[5], 3.0 * M) and _exact(k64[6], 2.0 * Q * Q)
    assert _exact(k64[2], 1.0 / r_obs)
    # float32 forms 2 M as float32 arithmetic on a float32 M.
    assert k32[3] == float(np.float32(2.0) * np.float32(M)) != k64[3]
