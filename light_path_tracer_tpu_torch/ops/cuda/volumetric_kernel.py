"""Wrappers of the hand-written CUDA extras kernel
(csrc/kerr_dp45_extras.cuh and its families' sources): the volumetric
(thin and self-absorbed), multi-frequency spectral, flare-movie,
photon-ring order and polarized (Stokes) transfer traces.

The counterpart of the single-pass entries of
`light_path_tracer_tpu.ops.pallas.volumetric_kernel`:
`trace_rays_volumetric_pallas`, `trace_rays_aux_pallas` (with its per-ray
auxiliary inputs) and `trace_rays_spectral_pallas`. The kernel runs one
thread per ray through initial conditions, the adaptive loop over 5 + n
extras components and the angle extraction, so a launch returns the
finished result; its two-pass drivers are in `kerr_trace_kernel.py`
beside the shadow and disk ones.

The kernel evaluates the transfer functions of `volumetric.py` and
`polarization.py` itself, from the description each one carries
(`fn.kernel`, a `volumetric.KernelTransfer`): the profile, the flow and
every constant. `KernelTransfer.constants` forms the constants in double,
as the JAX package's closures form them; `riaf_params` packs them for the
float32 instances, each rounded once (`RiafParams`), or unrounded for the
float64 ones (`RiafParams64`). A CUDA float32 or float64 tensor launches
the kernel instance of its dtype (the launch counters count per dtype:
`.launches`, `.launches_f64`), and any other CUDA input raises (another
dtype, a transfer function without a description, more than 8 bands or
frames, more than 4 orders, aux inputs the transfer function does not
take); CPU tensors run the plain loop (`ops/kerr_trace.py`). As in
`kerr_trace_kernel.py`, the private `_cycle_exit=False` grinds the exact
cycles the kernel otherwise counts at once, and `probe` receives their
census.

Each instance is built with its functor's block bound (kMinBlocks in
csrc/kerr_dp45_extras.cuh: the 128-thread blocks an SM must hold, which
caps its registers). `extras_instances` lists every compiled instance and
`describe_instance` reports one's registers, local memory and blocks an SM
on the current card.
"""

from __future__ import annotations

import ctypes

import torch

from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.cuda._build import check, load_library
from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
    _check_call, _check_inputs, count_launch, entry_suffix)
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    _h_init_for, get_tols, saturation_r_max, spectral_result,
    volumetric_result)
from light_path_tracer_tpu_torch.ops.types import ExtrasResult

__all__ = ["RiafParams", "RiafParams64", "ExtrasCall", "ExtrasCall64",
           "riaf_params", "extras_instances", "describe_instance",
           "trace_rays_volumetric_cuda", "trace_rays_aux_cuda",
           "trace_rays_spectral_cuda", "MAX_BANDS", "MAX_FRAMES",
           "MAX_ORDERS", "MAX_AUX"]

# What the families are compiled for (csrc/): spectral bands, movie
# frames, image orders (2..MAX_ORDERS) and per-ray aux constants.
MAX_BANDS = 8
MAX_FRAMES = 8
MAX_ORDERS = 4
MAX_AUX = 4

_PROFILES = {"torus": 0, "powerlaw": 1, "shell": 2, "jet": 3}
_FIELDS = {"vertical": 0, "toroidal": 1, "radial": 2}
_FLOATS = ("two_M", "a", "a2", "kep_num", "kep_add", "r_peak", "two_sig_r2",
           "two_h2", "index", "shell_in", "shell_out", "edge_width",
           "jet_cos", "two_jet_sig2", "jet_r_base", "jet_beta", "jet_gamma",
           "g_power", "alpha0", "q_minus_1", "tau_floor")
_SPOT_FLOATS = ("spot_amp", "spot_phase", "spot_omega", "spot_r", "spot_r2",
                "two_spot_sig2")
_ORDER_FLOATS = ("order_norm", "order_inv_two_sig2")
_STOKES_FLOATS = ("two_Ma", "two_Ma2", "flow_sign", "p0")


def _riaf_fields(real):
    """RiafParams<T>'s fields with real the ctypes type of T."""
    return ([("profile", ctypes.c_int), ("geometry", ctypes.c_int)]
            + [(name, real) for name in _FLOATS]
            + [("neg_c", real * MAX_BANDS), ("band_scale", real * MAX_BANDS)]
            + [(name, real) for name in _SPOT_FLOATS]
            + [("times", real * MAX_FRAMES)]
            + [(name, real) for name in _ORDER_FLOATS]
            + [("field", ctypes.c_int)]
            + [(name, real) for name in _STOKES_FLOATS])


def _call_fields(real):
    """ExtrasCall<T>'s fields with real the ctypes type of T: the device
    pointers and the stream first, then the 4-byte members, then the
    scalars."""
    return ([("alpha", ctypes.c_void_p), ("theta", ctypes.c_void_p),
             ("aux", ctypes.c_void_p * MAX_AUX)]
            + [(name, ctypes.c_void_p) for name in (
                "extras", "final_alpha", "n_half", "status", "steps",
                "census", "flags", "warp_steps", "stream")]
            + [(name, ctypes.c_int) for name in (
                "n", "form", "variant", "max_steps", "sat_window")]
            + [("sat_monitor", ctypes.c_uint), ("cycle_exit", ctypes.c_int)]
            + [(name, real) for name in (
                "M", "a", "r_plus", "r_obs", "theta_obs", "lambda_max",
                "atol", "rtol", "h_min", "tiny_err", "h_init", "r_capture",
                "r_reclass", "sat_r_max")])


class RiafParams(ctypes.Structure):
    """The float instances' RiafParams<float>, field for field."""

    _fields_ = _riaf_fields(ctypes.c_float)


class RiafParams64(ctypes.Structure):
    """The float64 instances' RiafParams<double>, field for field."""

    _fields_ = _riaf_fields(ctypes.c_double)


class ExtrasCall(ctypes.Structure):
    """The float instances' ExtrasCall<float>, field for field."""

    _fields_ = _call_fields(ctypes.c_float)


class ExtrasCall64(ctypes.Structure):
    """The float64 instances' ExtrasCall<double>, field for field."""

    _fields_ = _call_fields(ctypes.c_double)


def riaf_params(spec, dtype=torch.float32):
    """The kernel's RiafParams for a volumetric.KernelTransfer: its
    constants, formed in double by KernelTransfer.constants, each rounded
    once to float32 by ctypes for the float32 instances (RiafParams), or
    unrounded for the float64 ones (RiafParams64)."""
    k = spec.constants()
    names = _FLOATS + _SPOT_FLOATS + _ORDER_FLOATS + _STOKES_FLOATS
    struct = RiafParams64 if entry_suffix(dtype) else RiafParams
    p = struct(profile=_PROFILES[spec.riaf.profile],
               geometry=int(k["g_power"] == 0.0),
               field=_FIELDS.get(spec.field, 0),
               **{name: k[name] for name in names})
    for i, (ci, bs) in enumerate(zip(k["c"], k["band_scale"])):
        p.neg_c[i] = -ci
        p.band_scale[i] = bs
    for i, t in enumerate(spec.times):
        p.times[i] = t
    return p


def extras_instances():
    """Every compiled instance of the extras kernel, in float32 then
    float64: (label, C entry point, form, variant, dtype), the label as
    ptxas's report names the kernel (chip_smoke.kernel_label), e.g.
    "kerr_dp45_extras<Movie<8,absorbing=1,float>>"."""
    rows = [("VolThin<{}>", "lpt_kerr_dp45_extras", 0, 0),
            ("VolAbsorbed<{}>", "lpt_kerr_dp45_extras", 1, 0)]
    rows += [(f"Spectral<{b},{{}}>", "lpt_kerr_dp45_extras", 2, b)
             for b in range(1, MAX_BANDS + 1)]
    rows.append(("Stokes<{}>", "lpt_kerr_dp45_stokes", 0, 0))
    for ab in (0, 1):
        entry = ("lpt_kerr_dp45_movie_absorbed" if ab
                 else "lpt_kerr_dp45_movie_thin")
        rows += [(f"Movie<{f},absorbing={ab},{{}}>", entry, ab, f)
                 for f in range(1, MAX_FRAMES + 1)]
    rows += [(f"Order<{o},absorbing={ab},{{}}>", "lpt_kerr_dp45_orders", ab,
              o) for ab in (0, 1) for o in range(2, MAX_ORDERS + 1)]
    return [(f"kerr_dp45_extras<{label.format(real)}>", entry, form, variant,
             dtype)
            for dtype, real in ((torch.float32, "float"),
                                (torch.float64, "double"))
            for label, entry, form, variant in rows]


def describe_instance(entry, form, variant, dtype=torch.float32):
    """The resources of one extras instance on the current CUDA device, as
    the runtime reports them: blocks_per_sm (resident 128-thread blocks an
    SM), registers (a thread), local_bytes (a thread: spills and stack
    frame) and min_blocks (its __launch_bounds__ block bound). Builds the
    library on first use."""
    if not torch.cuda.is_available():
        raise RuntimeError("describe_instance queries the CUDA runtime; it "
                           "needs a CUDA device")
    lib = load_library()
    out = (ctypes.c_int * 4)()
    suffix = entry_suffix(dtype)
    rc = getattr(lib, f"{entry}_describe{suffix}")(int(form), int(variant),
                                                    out)
    check(lib, rc, f"{entry}_describe{suffix}")
    keys = ("blocks_per_sm", "registers", "local_bytes", "min_blocks")
    return dict(zip(keys, list(out)))


def _kernel_transfer(fn, kinds, metric):
    """The KernelTransfer a transfer function carries; raise when it has
    none (the kernel cannot run a Python closure) or it belongs to
    another metric."""
    spec = getattr(fn, "kernel", None)
    if spec is None or spec.kind not in kinds:
        raise NotImplementedError(
            "the CUDA extras kernel evaluates the transfer functions of "
            "light_path_tracer_tpu_torch.volumetric (make_transfer_fns, "
            "make_spectral_transfer, make_movie_transfer, "
            "make_order_transfer) and polarization "
            "(make_polarized_volumetric_transfer); other Python transfer "
            "functions run on CPU tensors only")
    if spec.metric != metric:
        raise ValueError(f"the transfer function was made for "
                         f"{spec.metric}, not {metric}")
    return spec


def _launch(entry, metric, r_obs, alphas, thetas, theta_obs, lambda_max,
            max_steps, precision, form, variant, n_extras, spec,
            sat_window, sat_monitor, probe, cycle_exit, aux=()):
    """One kernel launch through the C entry point `entry` (the instance
    of the rays' dtype); returns (ExtrasResult, unconverged mask)."""
    _check_inputs((("alphas", alphas, None), ("thetas", thetas, None))
                  + tuple((f"aux[{i}]", a, None)
                          for i, a in enumerate(aux)), alphas)
    if sat_window and not sat_monitor:
        raise ValueError("sat_window > 0 needs a non-empty sat_monitor "
                         "(with nothing monitored every in-band lane "
                         "would 'saturate')")
    if any(not 0 <= int(i) < n_extras for i in sat_monitor):
        raise ValueError(f"sat_monitor {tuple(sat_monitor)} names extras "
                         f"outside 0..{n_extras - 1}")
    n = alphas.numel()
    dtype, dev = alphas.dtype, alphas.device
    suffix = entry_suffix(dtype)
    extras = torch.empty((n_extras, n), dtype=dtype, device=dev)
    final_alpha = torch.empty(n, dtype=dtype, device=dev)
    n_half = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    n_steps = torch.empty((), dtype=torch.int64, device=dev)
    steps, census = ((torch.empty(n, dtype=torch.int32, device=dev),
                      torch.empty(n, dtype=torch.int32, device=dev))
                     if probe is not None else (None, None))
    tols = get_tols(dtype, precision)
    params = riaf_params(spec, dtype)
    lib = load_library()
    with torch.cuda.device(dev):
        call = (ExtrasCall64 if suffix else ExtrasCall)(
            alpha=alphas.data_ptr(), theta=thetas.data_ptr(),
            extras=extras.data_ptr(), final_alpha=final_alpha.data_ptr(),
            n_half=n_half.data_ptr(), status=status.data_ptr(),
            steps=None if steps is None else steps.data_ptr(),
            census=None if census is None else census.data_ptr(),
            flags=flags.data_ptr(), warp_steps=n_steps.data_ptr(),
            stream=torch.cuda.current_stream().cuda_stream,
            n=n, form=int(form), variant=int(variant),
            max_steps=int(max_steps), sat_window=int(sat_window),
            sat_monitor=sum(1 << int(i) for i in sat_monitor),
            cycle_exit=int(bool(cycle_exit)),
            M=float(metric.M), a=float(metric.a),
            r_plus=float(metric.r_plus), r_obs=float(r_obs),
            theta_obs=float(theta_obs), lambda_max=float(lambda_max),
            atol=tols["atol"], rtol=tols["rtol"], h_min=tols["h_min"],
            tiny_err=tols["tiny_err"], h_init=_h_init_for(r_obs),
            r_capture=float(metric.capture_radius()),
            r_reclass=float(metric.capture_radius() * 1.1),
            sat_r_max=saturation_r_max(metric) if sat_window else 0.0)
        for i, a in enumerate(aux):
            call.aux[i] = a.data_ptr()
        rc = getattr(lib, entry + suffix)(ctypes.byref(call),
                                          ctypes.byref(params))
    check(lib, rc, f"{entry}{suffix} launch")
    if probe is not None:
        probe["attempts"] = steps
        probe["flags"] = flags
        probe["cycles"] = census
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
                               probe: dict | None = None,
                               _cycle_exit: bool = True):
    """Volumetric transfer trace with the CUDA kernel; returns
    VolumetricResult (with return_unconverged, also the mask of rays
    still running with lambda budget left).

    Same arguments and result as ops.kerr_trace.trace_rays_volumetric;
    emission_fn/absorption_fn from volumetric.make_transfer_fns. The
    kernel's thin form (I) runs without absorption_fn, its self-absorbed
    form (I, tau) with it. alphas/thetas: CUDA float32 or float64. probe:
    a dict that receives the per-ray "attempts", the kernel's "flags" (bit
    0 unconverged, 1 saturation exit, 2 frozen-state exit) and the cycle
    census "cycles". Launches on the current stream and does not
    synchronise. CPU tensors go to the plain loop.
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
        "lpt_kerr_dp45_extras", metric, r_obs, alphas, thetas, theta_obs,
        lambda_max, max_steps, precision, int(absorbing), 0,
        2 if absorbing else 1, spec, sat_window, (0,), probe, _cycle_exit)
    count_launch(trace_rays_volumetric_cuda, alphas.dtype)
    result = volumetric_result(res, absorbing)
    return (result, unconv) if return_unconverged else result


# Kernel launches per dtype, so a run can show that it went through the
# kernel.
trace_rays_volumetric_cuda.launches = 0
trace_rays_volumetric_cuda.launches_f64 = 0


def _family(spec, n_extras, n_aux):
    """(C entry point, form, variant) of a transfer description, after
    checking its extras, aux count and compiled widths. The width is the
    number of bands, frames or orders; absorption adds the tau extra to
    the movie and order forms."""
    absorbing = int(spec.riaf.alpha0 > 0.0)
    movie_entry = ("lpt_kerr_dp45_movie_absorbed" if absorbing
                   else "lpt_kerr_dp45_movie_thin")
    # kind -> (entry, form, width, width limit, its name, extras, aux)
    entry, form, width, limit, what, expect, want_aux = {
        "spectral": ("lpt_kerr_dp45_extras", 2, len(spec.freqs), MAX_BANDS,
                     "bands", 1 + len(spec.freqs), 0),
        "movie": (movie_entry, absorbing, len(spec.times), MAX_FRAMES,
                  "frames", 1 + absorbing + len(spec.times), 0),
        "order": ("lpt_kerr_dp45_orders", absorbing, spec.n_orders,
                  MAX_ORDERS, "orders", 1 + absorbing + spec.n_orders, 0),
        "stokes": ("lpt_kerr_dp45_stokes", 0, 0, 0, "", 3, MAX_AUX),
    }[spec.kind]
    if n_extras != expect:
        raise ValueError(f"the {spec.kind} transfer has {expect} extras, "
                         f"not {n_extras}")
    if n_aux != want_aux:
        raise ValueError(f"the {spec.kind} transfer takes {want_aux} "
                         f"per-ray aux inputs, got {n_aux}")
    if width > limit:
        raise NotImplementedError(
            f"{width} {what}: the CUDA {spec.kind} kernel is built for up "
            f"to {limit} (ROADMAP.md, Queue 2)")
    return entry, form, width


def trace_rays_aux_cuda(metric, r_obs, alphas, thetas, theta_obs,
                        transfer_fn, n_extras: int, aux,
                        lambda_max: float, max_steps: int = 200000,
                        precision: str = "fast", method: str = "dp45",
                        sat_window: int = 0, sat_monitor: tuple = (),
                        return_unconverged: bool = False,
                        probe: dict | None = None,
                        _cycle_exit: bool = True):
    """Generic coupled-extras trace with the CUDA kernel; returns
    ExtrasResult (with return_unconverged, also the re-trace mask).

    The counterpart of trace_rays_aux_pallas: aux is a tuple of per-ray
    tensors of the rays' dtype and device (same length, contiguous), which
    the kernel reads once per ray into registers; as there, with aux =
    () the transfer function is called as transfer_fn(y, p_t, p_phi).
    The kernel runs the functions of volumetric.make_spectral_transfer
    (n_extras = 1 + bands), make_movie_transfer (1 + [1] + frames),
    make_order_transfer (1 + [1] + orders) and
    polarization.make_polarized_volumetric_transfer (3 extras, the four
    camera constants as aux). CPU tensors go to the plain loop.
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
    spec = _kernel_transfer(transfer_fn,
                            ("spectral", "movie", "order", "stokes"), metric)
    entry, form, variant = _family(spec, n_extras, len(aux))
    res, unconv = _launch(
        entry, metric, r_obs, alphas, thetas, theta_obs, lambda_max,
        max_steps, precision, form, variant, n_extras, spec, sat_window,
        sat_monitor, probe, _cycle_exit, aux)
    count_launch(trace_rays_aux_cuda, alphas.dtype)
    return (res, unconv) if return_unconverged else res


trace_rays_aux_cuda.launches = 0
trace_rays_aux_cuda.launches_f64 = 0


def trace_rays_spectral_cuda(metric, r_obs, alphas, thetas, theta_obs,
                             transfer_fn, n_bands: int, lambda_max: float,
                             max_steps: int = 200000,
                             precision: str = "fast", method: str = "dp45",
                             sat_window: int = 0, sat_monitor: tuple = None,
                             return_unconverged: bool = False,
                             probe: dict | None = None,
                             _cycle_exit: bool = True):
    """Multi-frequency transfer trace with the CUDA kernel (through
    trace_rays_aux_cuda, as trace_rays_spectral_pallas goes through
    trace_rays_aux_pallas); returns SpectralResult (with
    return_unconverged, also the re-trace mask). The movie and order
    transfers ride it too, with their bookkeeping component in the
    tau_hat slot. sat_monitor defaults to the n bands (extras 1..n). CPU
    tensors go to the plain loop."""
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
        return_unconverged=return_unconverged, probe=probe,
        _cycle_exit=_cycle_exit)
    if return_unconverged:
        return spectral_result(out[0]), out[1]
    return spectral_result(out)

