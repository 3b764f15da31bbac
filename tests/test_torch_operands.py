"""The plain loops' operand forms (light_path_tracer_tpu_torch/operands.py).

On a CUDA tensor the plain loops divide by, and raise to, 0-dim tensors
(what the kernels compute); on the CPU they keep the Python numbers (what
the parity tests hold against the JAX package). Both forms run here on
the CPU, on inputs made with numpy from a seed:
  * kernel_operand gives the Python float for a CPU tensor and a 0-dim
    tensor of the dtype on any other device;
  * a tensor divisor gives the Python number's quotient bit for bit;
  * a tensor exponent gives the Python number's power bit for bit except
    at 2, 3, -1, -2, 0.5 and -0.5, which PyTorch expands into products,
    reciprocals and square roots for a number; there the two stay within
    one ulp;
  * trace_rays_kerr (theta and mu charts, float32 and float64), whose
    operands are divisors only, is bit for bit the same in both forms;
  * the volumetric and spectral traces (float64), whose transfer raises g
    to a power, stay within rtol 1e-12 of each other.
"""

import math

import numpy as np
import pytest
import torch

from light_path_tracer_tpu_torch import operands, volumetric
from light_path_tracer_tpu_torch.models import Kerr, KerrNewman
from light_path_tracer_tpu_torch.models import kerr as kerr_model
from light_path_tracer_tpu_torch.ops import kerr_trace as tk

R_OBS = 100.0
THETA = float(np.radians(80.0))
DTYPES = [torch.float32, torch.float64]
EXPANDED = (2.0, 3.0, -1.0, -2.0, 0.5, -0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tensor_operand(x, like):
    """The card's form of kernel_operand, on the CPU."""
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


@pytest.fixture
def tensor_operands(monkeypatch):
    """Every plain loop that takes kernel_operand takes the card's form."""
    monkeypatch.setattr(tk, "kernel_operand", _tensor_operand)
    monkeypatch.setattr(kerr_model, "kernel_operand", _tensor_operand)
    monkeypatch.setattr(volumetric, "_k", _tensor_operand)


def _values(dtype, n=1 << 16, lo=0.05, hi=12.0, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(lo, hi, n), dtype=dtype)


def test_kernel_operand_is_the_number_on_the_cpu():
    x = torch.ones(3, dtype=torch.float32)
    got = operands.kernel_operand(2.5, x)
    assert type(got) is float and got == 2.5
    meta = torch.empty(3, dtype=torch.float64, device="meta")
    got = operands.kernel_operand(3, meta)
    assert isinstance(got, torch.Tensor)
    assert got.dim() == 0 and got.dtype == torch.float64
    assert got.device.type == "meta"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_tensor_divisor_is_bitwise_the_number_on_the_cpu(dtype):
    """The divisors the plain loops pass: the component counts of the
    error norm (5 to 7), pi, and the transfer's Gaussian widths, radii
    and edge widths."""
    x = _values(dtype)
    riaf = volumetric.RIAFConfig()
    for c in (5.0, 6.0, 7.0, math.pi, volumetric._two_sq(riaf.sigma_r),
              volumetric._two_sq(riaf.h_cos), riaf.r_peak, riaf.edge_width,
              volumetric._two_sq(riaf.spot_sigma)):
        assert torch.equal(x / c, x / _tensor_operand(c, x)), c


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_tensor_exponent_differs_only_where_pytorch_expands(dtype):
    x = _values(dtype)
    eps = torch.finfo(dtype).eps
    for e in (1.5, 4.0, 2.3, 3.5) + EXPANDED:
        a, b = x ** e, x ** _tensor_operand(e, x)
        if e in EXPANDED:
            rel = ((a.double() - b.double()).abs() / b.double().abs()).max()
            assert float(rel) <= eps, e
        else:
            assert torch.equal(a, b), e


def _bits(t):
    """A tensor's bit pattern (NaN compares equal to the same NaN)."""
    t = torch.as_tensor(t)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _kerr_rays(metric, dtype, n=64, seed=3):
    ac = metric.alpha_crit(R_OBS)
    rng = np.random.default_rng(seed)
    t = dict(dtype=dtype)
    return (torch.tensor(rng.uniform(0.3 * ac, 4 * ac, n), **t),
            torch.tensor(rng.uniform(-np.pi, np.pi, n), **t),
            torch.tensor(rng.random(n) < 0.2))


def _trace_kerr(metric, dtype, formulation, method):
    al, th, rf = _kerr_rays(metric, dtype)
    res = tk.trace_rays_kerr(metric, R_OBS, al, th, THETA, rf, 5000.0, 1000,
                             formulation=formulation, method=method)
    return [res.status, res.final_alpha, res.n_half_orbits,
            torch.as_tensor(res.n_steps)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("formulation,method,family",
                         [("theta", "dp45", "kerr"), ("mu", "dp45", "kerr"),
                          ("theta", "dop853", "kerr_newman"),
                          ("mu", "dop853", "kerr_newman")])
def test_kerr_trace_is_bitwise_in_both_forms_on_the_cpu(
        request, formulation, method, family, dtype):
    metric = (Kerr(M=1.0, a=0.9) if family == "kerr"
              else KerrNewman(M=1.0, a=0.6, Q=0.6))
    number = _trace_kerr(metric, dtype, formulation, method)
    request.getfixturevalue("tensor_operands")
    tensor = _trace_kerr(metric, dtype, formulation, method)
    for a, b in zip(number, tensor):
        assert torch.equal(_bits(a), _bits(b))


def _trace_volumetric(metric, form):
    al, th, _rf = _kerr_rays(metric, torch.float64, n=48, seed=4)
    R = volumetric.RIAFConfig
    if form == "spectral":
        riaf, freqs = R(g_power=4.0, alpha0=1.0, opacity_index=3.0), (
            0.1, 1.0, 10.0)
        tf = volumetric.make_spectral_transfer(metric, riaf, freqs)
        res = tk.trace_rays_spectral(metric, R_OBS, al, th, THETA, tf, 3,
                                     5000.0, 3000, sat_window=512)
        return res.status, torch.stack([res.tau_hat, *res.emission])
    riaf = R(alpha0=0.3) if form == "absorbed" else R()
    em, ab = volumetric.make_transfer_fns(metric, riaf)
    res = tk.trace_rays_volumetric(metric, R_OBS, al, th, THETA, em, 5000.0,
                                   3000, absorption_fn=ab, sat_window=512)
    return res.status, torch.stack([res.emission, res.optical_depth])


@pytest.mark.parametrize("form", ["thin", "absorbed", "spectral"])
def test_volumetric_trace_in_both_forms_on_the_cpu(request, form):
    metric = KerrNewman(M=1.0, a=0.6, Q=0.6)
    st_n, x_n = _trace_volumetric(metric, form)
    request.getfixturevalue("tensor_operands")
    st_t, x_t = _trace_volumetric(metric, form)
    assert torch.equal(st_n, st_t)
    scale = x_n.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
    assert float(((x_n - x_t).abs() / scale).max()) < 1e-12
