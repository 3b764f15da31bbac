"""Wrappers of the hand-written CUDA extras kernel
(csrc/kerr_dp45_extras.cu): the volumetric (thin and self-absorbed) and
the multi-frequency spectral transfer traces.

The counterpart of the single-pass entries of
`light_path_tracer_tpu.ops.pallas.volumetric_kernel`:
`trace_rays_volumetric_pallas`, and `trace_rays_aux_pallas` /
`trace_rays_spectral_pallas` for transfer functions without per-ray
auxiliary inputs. The kernel runs one thread per ray through initial
conditions, the adaptive loop over 5 + n extras components and the
angle extraction, so a launch returns the finished result; its two-pass
drivers are in `kerr_trace_kernel.py` beside the shadow and disk ones.

The kernel evaluates the transfer functions of `volumetric.py` itself,
from the description each one carries (`fn.kernel`, a
`volumetric.KernelTransfer`): the profile, the flow and every constant.
`KernelTransfer.constants` forms the constants in double, as the JAX
package's float32 closures form them, and `riaf_params` rounds each once.
A CUDA float32 tensor launches the kernel, and any other CUDA input raises (a float64 tensor, a transfer function without a
description, more than 8 bands, per-ray aux inputs); CPU tensors run the
plain loop (`ops/kerr_trace.py`).
"""

from __future__ import annotations

import ctypes

import torch

from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.cuda._build import check, load_library
from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
    _check_call, _check_inputs)
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    _h_init_for, get_tols, saturation_r_max, spectral_result,
    volumetric_result)
from light_path_tracer_tpu_torch.ops.types import ExtrasResult

__all__ = ["RiafParams", "riaf_params", "trace_rays_volumetric_cuda",
           "trace_rays_aux_cuda", "trace_rays_spectral_cuda", "MAX_BANDS"]

# Band counts the spectral form is compiled for (csrc/kerr_dp45_extras.cu).
MAX_BANDS = 8

_PROFILES = {"torus": 0, "powerlaw": 1, "shell": 2, "jet": 3}
_FLOATS = ("two_M", "a", "a2", "kep_num", "kep_add", "r_peak", "two_sig_r2",
           "two_h2", "index", "shell_in", "shell_out", "edge_width",
           "jet_cos", "two_jet_sig2", "jet_r_base", "jet_beta", "jet_gamma",
           "g_power", "alpha0", "q_minus_1", "tau_floor")


class RiafParams(ctypes.Structure):
    """The kernel's RiafParams, field for field (4-byte members, no
    padding)."""

    _fields_ = ([("profile", ctypes.c_int), ("geometry", ctypes.c_int)]
                + [(name, ctypes.c_float) for name in _FLOATS]
                + [("neg_c", ctypes.c_float * MAX_BANDS),
                   ("band_scale", ctypes.c_float * MAX_BANDS)])


def riaf_params(spec) -> RiafParams:
    """The kernel's RiafParams for a volumetric.KernelTransfer: its
    constants, formed in double by KernelTransfer.constants, each rounded
    once to float32 by ctypes."""
    k = spec.constants()
    p = RiafParams(profile=_PROFILES[spec.riaf.profile],
                   geometry=int(k["g_power"] == 0.0),
                   **{name: k[name] for name in _FLOATS})
    for i, (ci, bs) in enumerate(zip(k["c"], k["band_scale"])):
        p.neg_c[i] = -ci
        p.band_scale[i] = bs
    return p


def _kernel_transfer(fn, kinds, metric):
    """The KernelTransfer a transfer function carries; raise when it has
    none (the kernel cannot run a Python closure) or it belongs to
    another metric."""
    spec = getattr(fn, "kernel", None)
    if spec is None or spec.kind not in kinds:
        raise NotImplementedError(
            "the CUDA extras kernel evaluates the transfer functions of "
            "light_path_tracer_tpu_torch.volumetric (make_transfer_fns, "
            "make_spectral_transfer); other Python transfer functions run "
            "on CPU tensors only")
    if spec.metric != metric:
        raise ValueError(f"the transfer function was made for "
                         f"{spec.metric}, not {metric}")
    return spec


def _launch(metric, r_obs, alphas, thetas, theta_obs, lambda_max,
            max_steps, precision, form, n_extras, params, sat_window,
            sat_monitor, probe):
    """One kernel launch; returns (ExtrasResult, unconverged mask)."""
    _check_inputs((("alphas", alphas, torch.float32),
                   ("thetas", thetas, torch.float32)), alphas)
    if sat_window and not sat_monitor:
        raise ValueError("sat_window > 0 needs a non-empty sat_monitor "
                         "(with nothing monitored every in-band lane "
                         "would 'saturate')")
    n = alphas.numel()
    dev = alphas.device
    extras = torch.empty((n_extras, n), dtype=torch.float32, device=dev)
    final_alpha = torch.empty(n, dtype=torch.float32, device=dev)
    n_half = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    n_steps = torch.empty((), dtype=torch.int64, device=dev)
    steps = (torch.empty(n, dtype=torch.int32, device=dev)
             if probe is not None else None)
    tols = get_tols(torch.float32, precision)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lpt_kerr_dp45_extras(
            form, n_extras - 1, alphas.data_ptr(), thetas.data_ptr(),
            extras.data_ptr(), final_alpha.data_ptr(), n_half.data_ptr(),
            status.data_ptr(), None if steps is None else steps.data_ptr(),
            flags.data_ptr(), n_steps.data_ptr(), n,
            float(metric.M), float(metric.a), float(metric.r_plus),
            float(r_obs), float(theta_obs), float(lambda_max),
            int(max_steps), tols["atol"], tols["rtol"], tols["h_min"],
            tols["tiny_err"], _h_init_for(r_obs),
            float(metric.capture_radius()),
            float(metric.capture_radius() * 1.1), int(sat_window),
            sum(1 << int(i) for i in sat_monitor),
            saturation_r_max(metric) if sat_window else 0.0,
            ctypes.byref(params), stream)
    check(lib, rc, "kerr_dp45_extras launch")
    if probe is not None:
        probe["attempts"] = steps
        probe["flags"] = flags
    res = ExtrasResult(tuple(extras.unbind(0)), final_alpha, n_half, status,
                       n_steps)
    return res, (flags & 1).bool()


def _route(alphas, metric, method, max_steps):
    """True: launch the kernel (CUDA tensor); False: the plain loop."""
    if not _check_call(alphas, metric, "theta", max_steps):
        return False
    if method != "dp45":
        raise NotImplementedError(
            f"method={method!r}: the CUDA extras kernel integrates dp45")
    return True


def trace_rays_volumetric_cuda(metric, r_obs, alphas, thetas, theta_obs,
                               emission_fn, lambda_max: float,
                               max_steps: int = 200000,
                               precision: str = "fast",
                               method: str = "dp45", absorption_fn=None,
                               sat_window: int = 0,
                               return_unconverged: bool = False,
                               probe: dict | None = None):
    """Volumetric transfer trace with the CUDA kernel; returns
    VolumetricResult (with return_unconverged, also the mask of rays
    still running with lambda budget left).

    Same arguments and result as ops.kerr_trace.trace_rays_volumetric;
    emission_fn/absorption_fn from volumetric.make_transfer_fns. The
    kernel's thin form (I) runs without absorption_fn, its self-absorbed
    form (I, tau) with it. probe: a dict that receives the per-ray
    "attempts" and the kernel's "flags" (bit 0 unconverged, 1 saturation
    exit, 2 frozen-state exit). Launches on the current stream and does
    not synchronise. CPU tensors go to the plain loop.
    """
    if not _route(alphas, metric, method, max_steps):
        return tk.trace_rays_volumetric(
            metric, r_obs, alphas, thetas, theta_obs, emission_fn,
            lambda_max, max_steps, precision=precision, method=method,
            absorption_fn=absorption_fn, sat_window=sat_window,
            return_unconverged=return_unconverged)
    spec = _kernel_transfer(emission_fn, ("emission",), metric)
    if absorption_fn is not None:
        spec_a = _kernel_transfer(absorption_fn, ("absorption",), metric)
        if spec_a.riaf != spec.riaf:
            raise ValueError("emission_fn and absorption_fn describe "
                             "different RIAF configurations")
    absorbing = absorption_fn is not None
    res, unconv = _launch(
        metric, r_obs, alphas, thetas, theta_obs, lambda_max, max_steps,
        precision, int(absorbing), 2 if absorbing else 1,
        riaf_params(spec), sat_window, (0,), probe)
    trace_rays_volumetric_cuda.launches += 1
    result = volumetric_result(res, absorbing)
    return (result, unconv) if return_unconverged else result


# Kernel launches, so a run can show that it went through the kernel.
trace_rays_volumetric_cuda.launches = 0


def trace_rays_aux_cuda(metric, r_obs, alphas, thetas, theta_obs,
                        transfer_fn, n_extras: int, aux,
                        lambda_max: float, max_steps: int = 200000,
                        precision: str = "fast", method: str = "dp45",
                        sat_window: int = 0, sat_monitor: tuple = (),
                        return_unconverged: bool = False,
                        probe: dict | None = None):
    """Generic coupled-extras trace with the CUDA kernel; returns
    ExtrasResult (with return_unconverged, also the re-trace mask).

    The counterpart of trace_rays_aux_pallas for aux = (): as there, the
    transfer function is called as transfer_fn(y, p_t, p_phi). The
    kernel's spectral form runs volumetric.make_spectral_transfer's
    functions (n_extras = 1 + bands, at most 1 + MAX_BANDS); per-ray aux
    inputs (the polarized transfer) are a later slice of the port and
    raise. CPU tensors go to the plain loop.
    """
    aux = tuple(aux) if aux is not None else ()
    if not _route(alphas, metric, method, max_steps):
        extra = transfer_fn
        if not aux:
            def extra(y, p_t, p_phi, _aux):
                return transfer_fn(y, p_t, p_phi)
        return tk.trace_rays_aux(
            metric, r_obs, alphas, thetas, theta_obs, extra, n_extras, aux,
            lambda_max, max_steps, precision=precision, method=method,
            sat_window=sat_window, sat_monitor=sat_monitor,
            return_unconverged=return_unconverged)
    if aux:
        raise NotImplementedError(
            "per-ray aux inputs of the CUDA extras kernel (the polarized "
            "volumetric transfer) are not ported yet (ROADMAP.md, Queue 1)")
    spec = _kernel_transfer(transfer_fn, ("spectral",), metric)
    n_bands = len(spec.freqs)
    if n_extras != 1 + n_bands:
        raise ValueError(f"the spectral transfer of {n_bands} bands has "
                         f"{1 + n_bands} extras, not {n_extras}")
    if n_bands > MAX_BANDS:
        raise NotImplementedError(
            f"{n_bands} bands: the CUDA spectral kernel is built for 1.."
            f"{MAX_BANDS} (ROADMAP.md, Queue 1)")
    res, unconv = _launch(
        metric, r_obs, alphas, thetas, theta_obs, lambda_max, max_steps,
        precision, 2, n_extras, riaf_params(spec),
        sat_window, sat_monitor, probe)
    trace_rays_aux_cuda.launches += 1
    return (res, unconv) if return_unconverged else res


trace_rays_aux_cuda.launches = 0


def trace_rays_spectral_cuda(metric, r_obs, alphas, thetas, theta_obs,
                             transfer_fn, n_bands: int, lambda_max: float,
                             max_steps: int = 200000,
                             precision: str = "fast", method: str = "dp45",
                             sat_window: int = 0, sat_monitor: tuple = None,
                             return_unconverged: bool = False,
                             probe: dict | None = None):
    """Multi-frequency transfer trace with the CUDA kernel (through
    trace_rays_aux_cuda, as trace_rays_spectral_pallas goes through
    trace_rays_aux_pallas); returns SpectralResult (with
    return_unconverged, also the re-trace mask). sat_monitor defaults to
    the n bands (extras 1..n). CPU tensors go to the plain loop."""
    if sat_monitor is None:
        sat_monitor = tuple(range(1, 1 + n_bands))
    if not _route(alphas, metric, method, max_steps):
        return tk.trace_rays_spectral(
            metric, r_obs, alphas, thetas, theta_obs, transfer_fn, n_bands,
            lambda_max, max_steps, precision=precision, method=method,
            sat_window=sat_window, sat_monitor=sat_monitor,
            return_unconverged=return_unconverged)
    out = trace_rays_aux_cuda(
        metric, r_obs, alphas, thetas, theta_obs, transfer_fn, 1 + n_bands,
        (), lambda_max, max_steps, precision=precision, method=method,
        sat_window=sat_window, sat_monitor=sat_monitor,
        return_unconverged=return_unconverged, probe=probe)
    if return_unconverged:
        return spectral_result(out[0]), out[1]
    return spectral_result(out)

