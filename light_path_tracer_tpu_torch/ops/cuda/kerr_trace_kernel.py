"""Wrapper of the hand-written CUDA Kerr kernel (csrc/kerr_dp45.cu), and
the two-pass straggler drivers over it.

The counterpart of `light_path_tracer_tpu.ops.pallas.kerr_trace_kernel`.
A call is one kernel launch: each ray's initial conditions, plunge
radius, whole adaptive loop, escape-angle extraction (the plain loop's
`finalize_angles`) and its share of the warp step sum run in the kernel,
which writes final_alpha, n_half and the status (the JAX wrapper extracts
the angle outside its kernel only because Mosaic cannot lower acos). Its
disk variant (`trace_disk_rays_cuda`, `trace_disk_rays_pallas` in JAX)
adds the plane-crossing recorder and writes p_phi and the hit records
too: 1 to 4 slots through the instances of csrc/kerr_dp45.cu, 5 to 8
through its wide instances (csrc/kerr_dp45_wide.cu and siblings; the DP45
ones in the library `_build.load_library("more")` builds at their first
launch), more through the plane recorder as one equatorial plane (its
kind 0, bitwise the disk variant in every output both write). A tilted or
warped plane, a second plane or the crossing-time recorder goes to the
plane-recorder instances (csrc/kerr_planes.cuh through
csrc/kerr_dp45_planes.cu and its f64 and DOP853 siblings;
`trace_disk_rays_cuda` with disk_normal, extra_disks or record_time,
`trace_disk_rays_multi_cuda`), one or two planes of any number of slots;
three or more planes go to its broad instances
(csrc/kerr_dp45_broad_planes.cu and siblings, in the library
`_build.load_library("broad")` builds at their first launch), which read
the plane count at run time and keep each plane's detectors in a
workspace of 2 x planes x rays scalars on the device. The
kernel runs one thread a ray in index order. It computes three
metric families, Kerr, Kerr-Newman and Johannsen-Psaltis (the shadow
variant; the disk variant takes the first two), each named to the kernel
by the metric's exact class: any other class raises, a subclass included.
It runs either embedded pair of the JAX kernel's `method`: "dp45" launches
the DP45 instances, "dop853" the DOP853 ones (csrc/kerr_dop853.cu, in the
library `_build.load_library("dop853")` builds at their first launch), and
any other method raises on a CUDA tensor. The shadow variant also takes
`event_interp` ("hermite" or "linear"); the disk variant is Hermite only,
as the JAX package's Pallas disk wrapper is. The shadow variant integrates
either chart of the JAX kernel's `formulation`: "theta", or "mu" (mu =
cos(theta), the instances of csrc/kerr_dp45_mu.cu and its siblings, Kerr
and Kerr-Newman only; the DP45 ones in the library
`_build.load_library("more")` builds at their first launch), which also
takes the hybrid tracer's
`force_invalid` mask; a Johannsen-Psaltis metric or a disk trace with
"mu" raises, as in the JAX package.

`trace_rays_kerr_cuda` and `trace_disk_rays_cuda` launch the kernel on
CUDA float32 or float64 tensors (the float64 instances, entries `*_f64`,
with the float64 tolerance presets) and raise on any other CUDA input;
they never fall back. Each wrapper counts its launches per pair and dtype
(`.launches` DP45 float32, `.launches_f64` DP45 float64,
`.launches_dop853` and `.launches_dop853_f64`), the mu and wide
instances on counters of their own (`.launches_mu`, `.launches_mu_f64`,
`.launches_mu_dop853`, `.launches_mu_dop853_f64`; `.launches_wide`,
`.launches_planes`, `.launches_broad`, ...); a launch with run-time
parameters (`dynamic_params`, the sequences' (M, a) or (M, a, r_obs))
counts on `.dynamic_` + its counter too (`.dynamic_launches`,
`.dynamic_launches_mu`, ...). Given CPU tensors they run
the kernel's plain version, the PyTorch loop (`trace_rays_kerr_plain`,
`trace_disk_rays_plain`, ops/kerr_trace.py), because there is no kernel
to run there; the tests and the chip smoke test compare the two.

The kernels end a lane frozen in an exact cycle at once
(csrc/kerr_dp45_common.cuh, CycleWatch), which changes no output. The
private keyword `_cycle_exit=False` makes them grind such lanes as the
attempts would, for the bitwise check of the exit; `probe` receives the
per-ray cycle census ("cycles": the final frozen streak in bits 0-19,
bit 20 set where lambda moved along it, the first cycle's period in bits
21-30), beside the raw final "state", "raw_status", "attempts" and the
ray's "p_phi" (what `finalize_angles` needs to redo the extraction).

`trace_rays_kerr_hybrid` is the mu chart's driver with the JAX Pallas
backend's semantics (its docstring). `trace_rays_kerr_two_pass` and
`trace_disk_rays_two_pass`, and the drivers over the extras kernel
(`volumetric_kernel.py`): `trace_rays_volumetric_two_pass`,
`trace_rays_aux_two_pass` and `trace_rays_spectral_two_pass` (pass 1
capped at 4,096 attempts, 1,024 slots), keep the JAX drivers' semantics
on either device: a first pass capped at `pass1_steps` attempts per ray,
then the first `slots` rays still running, in index order, re-traced
from scratch with the full budget and scattered back; rays beyond `slots` keep their first-pass
result, and n_steps is the sum of both passes. The kernel computes every
ray on its own thread, so the result equals a single pass bitwise
whenever at most `slots` rays are unconverged. (The plain
loop on the CPU is elementwise too, but PyTorch may round a
transcendental function differently in a vectorised body than in its
scalar tail, so there it is exact when both passes' batch
sizes are multiples of 32.)
"""

from __future__ import annotations

import ctypes
import math

import torch

from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman, TracedKerr)
from light_path_tracer_tpu_torch.ops.cuda._build import check, load_library
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    INVALID, POLAR_OBSERVER_SIN, WarpedBasis, _h_init_for, check_method,
    get_tols, hybrid_poison, hybrid_slots, merge_results, stragglers,
    traced_scalars)
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    trace_disk_rays_kerr as trace_disk_rays_plain)
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    trace_rays_kerr as trace_rays_kerr_plain)
from light_path_tracer_tpu_torch.ops.types import DiskTraceResult, TraceResult

__all__ = ["trace_rays_kerr_cuda", "trace_rays_kerr_plain",
           "trace_disk_rays_cuda", "trace_disk_rays_plain",
           "trace_disk_rays_multi_cuda",
           "trace_rays_kerr_two_pass", "trace_disk_rays_two_pass",
           "trace_rays_kerr_hybrid",
           "trace_rays_volumetric_two_pass", "trace_rays_aux_two_pass",
           "trace_rays_spectral_two_pass"]

# Crossing slots of the disk variant: 1..NARROW_KERNEL_HITS through an
# instance a count (csrc/kerr_dp45.cu), up to MAX_KERNEL_HITS through the
# wide instances (csrc/kerr_dp45_wide.cu), more through the plane recorder.
NARROW_KERNEL_HITS = 4
MAX_KERNEL_HITS = 8

# The metric families of the Kerr kernels (csrc/kerr_dp45_common.cuh kKerr,
# kKerrNewman, kJohannsenPsaltis), keyed by the class that models each; a
# TracedKerr (run-time (M, a), its radii formed in float32) is Kerr.
FAMILIES = {Kerr: 0, KerrNewman: 1, JohannsenPsaltis: 2, TracedKerr: 0}
# The families of the disk variant, of the mu chart's instances and of
# the extras kernel.
DISK_FAMILIES = (Kerr, KerrNewman)
MU_FAMILIES = (Kerr, KerrNewman, TracedKerr)
EXTRAS_FAMILIES = (Kerr, KerrNewman)
# The charts of the shadow variant (KerrCall::chart).
CHARTS = ("theta", "mu")
# The sets of instances with launch counters of their own: the theta
# chart's (no infix), the mu chart's, the wide disk, the plane-recorder
# and the broad instances (the run-time widths of csrc/*_broad*.cu).
VARIANTS = CHARTS + ("wide", "planes", "broad")
# Planes of the plane recorder's PlaneSet instances (csrc/kerr_planes.cuh
# kMaxPlanes); more go to its broad instances.
MAX_KERNEL_PLANES = 2


def metric_family(metric, families=tuple(FAMILIES)) -> int:
    """The kernel's family code of `metric`, by its exact class; TypeError
    for a class outside `families`: the kernel computes no other metric,
    and a subclass may change what its parent computes."""
    if type(metric) not in families:
        raise TypeError(
            f"the CUDA kernel traces "
            f"{', '.join(c.__name__ for c in families)}; got "
            f"{type(metric).__name__}")
    return FAMILIES[type(metric)]


def entry_suffix(dtype) -> str:
    """The C entry points' suffix for a floating dtype: '' for float32,
    '_f64' for float64; ValueError for any other dtype."""
    if dtype == torch.float32:
        return ""
    if dtype == torch.float64:
        return "_f64"
    raise ValueError(f"the CUDA kernels take float32 or float64 rays, got "
                     f"{dtype}")


def method_suffix(method) -> str:
    """The C entry points' infix for an embedded pair: '' for "dp45",
    '_dop853' for "dop853" (the entry is name + infix + entry_suffix);
    ValueError for any other method, the fixed-step "rk4" included (it
    has no kernel: ops/kerr_rk4.py)."""
    check_method(method)
    return "_dop853" if method == "dop853" else ""


def library_of(method, variant=False) -> str:
    """The kernel library (ops/cuda/_build.py) that holds `method`'s
    instances: "dop853" for every DOP853 one; for DP45, "more" for the mu
    chart's, the wide disk, the plane-recorder and the Kerr-Newman
    extras' (variant), "dp45" for the rest."""
    if method_suffix(method):
        return "dop853"
    return "more" if variant else "dp45"


def counter_name(dtype, method="dp45", chart="theta") -> str:
    """A wrapper's launch counter for the pair, dtype and set of
    instances (VARIANTS): "launches", "launches_f64", "launches_dop853"
    or "launches_dop853_f64", with "_mu", "_wide", "_planes" or "_broad"
    after "launches" for the mu chart's, the wide disk, the
    plane-recorder or the broad instances."""
    return ("launches" + ("" if chart == "theta" else "_" + chart)
            + method_suffix(method)
            + ("_f64" if dtype == torch.float64 else ""))


def count_launch(fn, dtype, method="dp45", chart="theta", dynamic=False):
    """One launch of a kernel wrapper, on its counter for the pair, dtype
    and chart; a launch with run-time parameters (dynamic_params) also on
    "dynamic_" + that counter."""
    name = counter_name(dtype, method, chart)
    setattr(fn, name, getattr(fn, name) + 1)
    if dynamic:
        setattr(fn, "dynamic_" + name, getattr(fn, "dynamic_" + name) + 1)


def zero_counters(fn):
    """Set every launch counter of a kernel wrapper to 0, the dynamic_
    ones too."""
    for dtype in (torch.float32, torch.float64):
        for method in ("dp45", "dop853"):
            for chart in VARIANTS:
                name = counter_name(dtype, method, chart)
                setattr(fn, name, 0)
                setattr(fn, "dynamic_" + name, 0)


def _check_inputs(tensors, alphas):
    """tensors: (name, tensor, dtype) with dtype None for the rays' own
    floating dtype (float32 or float64)."""
    entry_suffix(alphas.dtype)
    for name, t, dtype in tensors:
        dtype = dtype or alphas.dtype
        if t.dtype != dtype:
            raise ValueError(f"the CUDA kernel takes {name} as {dtype}, got "
                             f"{t.dtype}")
        if t.device != alphas.device:
            raise ValueError(f"{name} is on {t.device}, alphas on "
                             f"{alphas.device}")
        if t.dim() != 1 or t.shape != alphas.shape:
            raise ValueError(f"{name} must have shape {tuple(alphas.shape)},"
                             f" got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if alphas.numel() >= 2**31:
        raise ValueError("at most 2**31 - 1 rays per launch")


def _check_call(alphas, metric, formulation, max_steps,
                families=tuple(FAMILIES), charts=("theta",)):
    """Raise on what the kernel does not take (a metric outside
    `families`, a chart outside `charts`, a mu chart of a family without
    one); False for a CPU tensor (the plain version runs), True for a
    CUDA tensor."""
    if alphas.device.type == "cpu":
        return False
    if alphas.device.type != "cuda":
        raise ValueError(f"no Kerr kernel for device {alphas.device}")
    if formulation not in CHARTS:
        raise ValueError(f"formulation must be 'theta' or 'mu', got "
                         f"{formulation!r}")
    if formulation not in charts:
        raise ValueError(f"formulation={formulation!r}: this kernel "
                         f"integrates the theta chart only")
    metric_family(metric, families)
    if formulation == "mu" and type(metric) not in MU_FAMILIES:
        raise NotImplementedError(
            f"the mu chart is wired for the Kerr and Kerr-Newman RHS only; "
            f"{type(metric).__name__} integrates in theta")
    if max_steps >= 2**31:
        raise ValueError("max_steps must fit in int32")
    return True


def _kerr_call_fields(real):
    """KerrCall<T>'s fields (csrc/kerr_dp45.cu) with real the ctypes type
    of T: the device pointers and the stream, the ints, then the
    scalars."""
    return ([(name, ctypes.c_void_p) for name in (
        "alpha", "theta", "refine", "force_invalid", "final_alpha",
        "n_half", "status",
        "flags", "p_phi", "hits", "r_hits", "phi_hits", "pr_hits",
        "pth_hits", "state", "raw_status", "steps", "census", "warp_steps",
        "stream")]
        + [(name, ctypes.c_int) for name in (
            "n", "max_steps", "cycle_exit", "max_hits", "momentum",
            "opaque", "family", "event_interp", "chart")]
        + [(name, real) for name in (
            "M", "a", "r_plus", "r_obs", "theta_obs", "lambda_max", "atol",
            "rtol", "atol_ref", "rtol_ref", "h_min", "tiny_err", "h_init",
            "r_capture", "r_reclass", "r_in", "r_out_disk", "plane_c", "q2",
            "r_pro", "eps3", "r_freeze")])


class KerrCall(ctypes.Structure):
    """The float instances' KerrCall<float>, field for field."""

    _fields_ = _kerr_call_fields(ctypes.c_float)


class KerrCall64(ctypes.Structure):
    """The float64 instances' KerrCall<double>, field for field."""

    _fields_ = _kerr_call_fields(ctypes.c_double)


def _ptr(t):
    return None if t is None else t.data_ptr()


def to_device(t, device):
    """A host tensor on `device`: to a CUDA device through pinned memory
    without waiting for the stream (a pageable copy would wait for every
    launch queued before it)."""
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def family_scalars(metric) -> dict:
    """KerrCall's family fields of `metric`: the code, Kerr-Newman's Q^2
    and numeric prograde photon-orbit radius (its plunge exit),
    Johannsen-Psaltis's eps3 and RHS freeze radius; 0 where the family
    has none. A Kerr-Newman metric with Q = 0 computes Kerr's batched
    hot path bitwise (models/kerr_newman.py), so it launches the Kerr
    instance."""
    family = metric_family(metric)
    kn, jp = type(metric) is KerrNewman, type(metric) is JohannsenPsaltis
    if kn and not metric.Q:
        family, kn = FAMILIES[Kerr], False
    return dict(
        family=family, q2=float(metric._q2),
        r_pro=float(metric.unstable_photon_radii()[0]) if kn else 0.0,
        eps3=float(metric.eps3) if jp else 0.0,
        r_freeze=float(metric._freeze_radius()) if jp else 0.0)


def _launch(metric, r_obs, alphas, thetas, theta_obs, lambda_max,
            max_steps, precision, refine, disk, flags, probe, cycle_exit,
            method="dp45", event_interp="hermite", chart="theta",
            force_invalid=None, planes=None):
    """One launch of the kernel through its C entry point (the instance of
    the chart, the pair and the rays' dtype): the shadow variant, or the
    disk variant when `disk` holds (r_in, r_out, theta_plane, opaque,
    max_hits, momentum; the wide instances above NARROW_KERNEL_HITS).
    With `planes` (a PlaneSet, or a PlaneList for the broad instances,
    whose pointers name the hit outputs) it launches the plane-recorder
    instance instead and `disk` gives only max_hits and momentum. Returns
    the per-ray outputs by name, "n_steps" the warp step sum (0-dim
    int64); "flags", the rays whose raw status is still RUNNING (bool),
    only when asked for."""
    n = alphas.numel()
    dtype, dev = alphas.dtype, alphas.device
    suffix = entry_suffix(dtype)

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)
    out = dict(final_alpha=empty(n), n_half=empty(n, dt=torch.int32),
               status=empty(n, dt=torch.int32))
    warp_steps = empty(dt=torch.int64)
    if flags:
        out["flags"] = empty(n, dt=torch.bool)
    if probe is not None:
        probe.update(state=empty(5, n), raw_status=empty(n, dt=torch.int32),
                     attempts=empty(n, dt=torch.int32),
                     cycles=empty(n, dt=torch.int32), p_phi=empty(n))
    probe_t = probe or {}
    p_phi = probe_t.get("p_phi")
    r_in = r_out = plane_c = 0.0
    opaque = max_hits = momentum = 0
    if disk is not None:
        r_in, r_out, theta_plane, opaque, max_hits, momentum = disk
        plane_c = math.cos(theta_plane)
        out["p_phi"] = p_phi = empty(n) if p_phi is None else p_phi
        if planes is None:
            out["n_hits"] = empty(n, dt=torch.int32)
            for k in ("r", "phi") + (("pr", "pth") if momentum else ()):
                out[k] = empty(max_hits, n)
    tols = get_tols(dtype, precision)
    wide = planes is None and max_hits > NARROW_KERNEL_HITS
    broad = isinstance(planes, PlaneList)
    infix = ("_mu" if chart == "mu" else "") + ("_wide" if wide else "") + (
        "" if planes is None else "_broad_planes" if broad else "_planes")
    entry = "lpt_kerr_dp45" + infix + method_suffix(method) + suffix
    lib = load_library("broad" if broad else library_of(method, bool(infix)))
    with torch.cuda.device(dev):
        call = (KerrCall64 if suffix else KerrCall)(
            alpha=alphas.data_ptr(), theta=thetas.data_ptr(),
            refine=_ptr(refine), force_invalid=_ptr(force_invalid),
            final_alpha=out["final_alpha"].data_ptr(),
            n_half=out["n_half"].data_ptr(),
            status=out["status"].data_ptr(), flags=_ptr(out.get("flags")),
            p_phi=_ptr(p_phi), hits=_ptr(out.get("n_hits")),
            r_hits=_ptr(out.get("r")), phi_hits=_ptr(out.get("phi")),
            pr_hits=_ptr(out.get("pr")), pth_hits=_ptr(out.get("pth")),
            state=_ptr(probe_t.get("state")),
            raw_status=_ptr(probe_t.get("raw_status")),
            steps=_ptr(probe_t.get("attempts")),
            census=_ptr(probe_t.get("cycles")),
            warp_steps=warp_steps.data_ptr(),
            stream=torch.cuda.current_stream().cuda_stream,
            n=n, max_steps=int(max_steps), cycle_exit=int(bool(cycle_exit)),
            max_hits=int(max_hits), momentum=int(bool(momentum)),
            opaque=int(bool(opaque)),
            event_interp=int(event_interp == "linear"),
            chart=CHARTS.index(chart),
            M=float(metric.M), a=float(metric.a),
            r_plus=float(metric.r_plus), r_obs=float(r_obs),
            theta_obs=float(theta_obs), lambda_max=float(lambda_max),
            atol=tols["atol"], rtol=tols["rtol"],
            atol_ref=tols["atol_ref"], rtol_ref=tols["rtol_ref"],
            h_min=tols["h_min"], tiny_err=tols["tiny_err"],
            h_init=_h_init_for(r_obs),
            r_capture=float(metric.capture_radius()),
            r_reclass=float(metric.reclass_radius()),
            r_in=float(r_in), r_out_disk=float(r_out), plane_c=plane_c,
            **family_scalars(metric))
        if planes is not None:
            rc = getattr(lib, entry)(ctypes.byref(call),
                                     ctypes.byref(planes))
        else:
            rc = getattr(lib, entry)(ctypes.byref(call),
                                     int(disk is not None))
    check(lib, rc, f"{entry} launch")
    out["n_steps"] = warp_steps
    return out


def trace_rays_kerr_cuda(metric, r_obs, alphas, thetas, theta_obs,
                         axis_refine, lambda_max: float,
                         max_steps: int = 200000, precision: str = "fast",
                         formulation: str = "theta",
                         return_unconverged: bool = False,
                         probe: dict | None = None,
                         _cycle_exit: bool = True, method: str = "dp45",
                         event_interp: str = "hermite", force_invalid=None,
                         dynamic_params=None):
    """Trace N rays of a Kerr, Kerr-Newman or Johannsen-Psaltis metric
    with the CUDA kernel; returns TraceResult.

    Same arguments and result as trace_rays_kerr_plain (with
    return_unconverged, (TraceResult, raw-RUNNING mask)). method: "dp45"
    or "dop853"; event_interp: "hermite" or "linear"; formulation:
    "theta", or "mu" (Kerr and Kerr-Newman), whose instances also take
    force_invalid, an (N,) bool mask of rays started INVALID (the theta
    instances do not read it: a mask with "theta" raises). alphas/thetas:
    (N,) contiguous CUDA tensors, both float32 or both float64 (the
    instance and the tolerance preset follow); axis_refine: (N,) bool on
    the same device. probe: a dict that receives the per-ray raw final
    "state" (5, N; in theta, the mu instances convert it back),
    "raw_status", "attempts", "cycles" and "p_phi" (the module
    docstring). dynamic_params: run-time (M, a) or (M, a, r_obs), float32
    only (ops.kerr_trace.traced_scalars): the launch then takes the
    TracedKerr's float32 M, a, r_+, capture and reclassification radii,
    and with three values the float32 radius, its escape radius and
    first step; no other instance is needed. One kernel launch on the
    current stream, which does not synchronise. CPU tensors go to the
    plain version; other devices raise.
    """
    if not _check_call(alphas, metric, formulation, max_steps,
                       charts=CHARTS):
        return trace_rays_kerr_plain(
            metric, r_obs, alphas, thetas, theta_obs, axis_refine,
            lambda_max, max_steps, precision=precision,
            formulation=formulation, return_unconverged=return_unconverged,
            method=method, event_interp=event_interp,
            force_invalid=force_invalid, dynamic_params=dynamic_params)
    metric, r_obs = traced_scalars(metric, r_obs, dynamic_params,
                                   alphas.dtype)
    check_method(method, event_interp)
    inputs = (("alphas", alphas, None), ("thetas", thetas, None),
              ("axis_refine", axis_refine, torch.bool))
    if force_invalid is not None:
        if formulation != "mu":
            raise ValueError("force_invalid is read by the mu chart's "
                             "instances only")
        inputs += (("force_invalid", force_invalid, torch.bool),)
    _check_inputs(inputs, alphas)
    out = _launch(metric, r_obs, alphas, thetas, theta_obs, lambda_max,
                  max_steps, precision, axis_refine, None,
                  return_unconverged, probe, _cycle_exit, method,
                  event_interp, formulation, force_invalid)
    count_launch(trace_rays_kerr_cuda, alphas.dtype, method, formulation,
                 dynamic_params is not None)
    result = TraceResult(out["final_alpha"], out["n_half"], out["status"],
                         out["n_steps"])
    if return_unconverged:
        return result, out["flags"]
    return result


# Kernel launches per pair and dtype, so a run can show that it went
# through the kernel.
zero_counters(trace_rays_kerr_cuda)


def trace_disk_rays_cuda(metric, r_obs, alphas, thetas, theta_obs,
                         lambda_max: float, max_steps: int, disk_plane,
                         max_disk_hits: int = 2, precision: str = "fast",
                         formulation: str = "theta",
                         return_unconverged: bool = False,
                         record_momentum: bool = False,
                         probe: dict | None = None,
                         _cycle_exit: bool = True, method: str = "dp45",
                         disk_normal=None, extra_disks=None,
                         record_time: bool = False):
    """Trace N rays of a Kerr or Kerr-Newman metric with the kernel's
    disk variant; returns DiskTraceResult (with extra_disks a tuple of
    them, one a plane; with return_unconverged, (result, raw-RUNNING
    mask)).

    Same arguments and result as trace_disk_rays_plain, whose events are
    then Hermite too; method "dp45" or "dop853". disk_plane =
    (r_in, r_out, theta_plane, opaque); max_disk_hits >= 1 (5..8
    through the wide instances, more through the plane recorder as one
    equatorial plane; fewer than 1 raises ValueError). A disk_normal (a
    flat basis or ops.kerr_trace.WarpedBasis), planes in extra_disks or
    record_time launch the plane-recorder instances (three or more
    planes its broad ones). alphas/
    thetas: (N,) contiguous CUDA tensors, both float32 or both float64.
    probe: as trace_rays_kerr_cuda's. One kernel launch on the current
    stream, which does not synchronise. CPU tensors go to the plain
    version.
    """
    if not _check_call(alphas, metric, formulation, max_steps,
                       DISK_FAMILIES):
        if formulation != "theta":
            raise ValueError("disk mode supports formulation='theta' only")
        return trace_disk_rays_plain(
            metric, r_obs, alphas, thetas, theta_obs, lambda_max,
            max_steps, disk_plane, max_disk_hits, precision=precision,
            return_unconverged=return_unconverged,
            record_momentum=record_momentum, method=method,
            disk_normal=disk_normal, extra_disks=extra_disks,
            record_time=record_time)
    check_method(method)
    _check_inputs((("alphas", alphas, None), ("thetas", thetas, None)),
                  alphas)
    if max_disk_hits < 1:
        raise ValueError(f"max_disk_hits must be at least 1, got "
                         f"{max_disk_hits}")
    if (disk_normal is not None or extra_disks or record_time
            or max_disk_hits > MAX_KERNEL_HITS):
        planes = [(disk_plane, disk_normal)] + list(extra_disks or ())
        return _trace_planes(metric, r_obs, alphas, thetas, theta_obs,
                             lambda_max, max_steps, planes, max_disk_hits,
                             precision, return_unconverged,
                             record_momentum, probe, _cycle_exit, method,
                             record_time, multi=bool(extra_disks))
    r_in, r_out, theta_plane, opaque = disk_plane
    out = _launch(metric, r_obs, alphas, thetas, theta_obs, lambda_max,
                  max_steps, precision, None,
                  (r_in, r_out, theta_plane, opaque, max_disk_hits,
                   record_momentum),
                  return_unconverged, probe, _cycle_exit, method)
    count_launch(trace_disk_rays_cuda, alphas.dtype, method,
                 "wide" if max_disk_hits > NARROW_KERNEL_HITS else "theta")

    def rows(k):
        return tuple(out[k].unbind(0)) if k in out else ()
    result = DiskTraceResult(out["status"], out["n_hits"], rows("r"),
                             out["p_phi"], out["n_steps"],
                             out["final_alpha"], out["n_half"], rows("phi"),
                             (), rows("pr"), rows("pth"))
    if return_unconverged:
        return result, out["flags"]
    return result


zero_counters(trace_disk_rays_cuda)


def trace_disk_rays_multi_cuda(metric, r_obs, alphas, thetas, theta_obs,
                               lambda_max: float, max_steps: int, planes,
                               max_disk_hits: int = 2,
                               precision: str = "fast",
                               return_unconverged: bool = False,
                               record_momentum: bool = False,
                               probe: dict | None = None,
                               method: str = "dp45",
                               record_time: bool = False):
    """Several disk planes in one trace: planes = [((r_in, r_out,
    theta_plane, opaque), normal), ...]; returns a tuple of
    DiskTraceResult, one a plane (trace_disk_rays_cuda with extra_disks).
    On a CUDA tensor the plane-recorder instances take one or two planes,
    its broad instances more."""
    (plane0, normal0), rest = planes[0], tuple(planes[1:])
    out = trace_disk_rays_cuda(
        metric, r_obs, alphas, thetas, theta_obs, lambda_max, max_steps,
        plane0, max_disk_hits, precision=precision,
        return_unconverged=return_unconverged,
        record_momentum=record_momentum, probe=probe, method=method,
        disk_normal=normal0, extra_disks=rest, record_time=record_time)
    if rest:
        return out
    return ((out[0],), out[1]) if return_unconverged else (out,)


class PlaneSpec(ctypes.Structure):
    """One plane of PlaneSet (csrc/kerr_planes.cuh), field for field, in
    double: kind (0 the equatorial cos(theta) detector, 1 a flat basis,
    2 a warp), opacity, then the outputs' pointers and the numbers."""

    _fields_ = ([("kind", ctypes.c_int), ("opaque", ctypes.c_int)]
                + [(name, ctypes.c_void_p) for name in (
                    "hits", "r", "phi", "xi", "t", "pr", "pth")]
                + [(name, ctypes.c_double) for name in (
                    "r_in", "r_out", "plane_c", "tilt", "sl", "cl",
                    "warp_radius", "power")]
                + [("basis", ctypes.c_double * 9)])


class PlaneSet(ctypes.Structure):
    """The plane-recorder launch's planes (csrc/kerr_planes.cuh)."""

    _fields_ = [("n_planes", ctypes.c_int), ("record_time", ctypes.c_int),
                ("t_end", ctypes.c_void_p), ("accepted", ctypes.c_void_p),
                ("planes", PlaneSpec * MAX_KERNEL_PLANES)]


class PlaneList(ctypes.Structure):
    """The broad plane-recorder launch's planes (csrc/kerr_planes.cuh):
    PlaneSet's fields with the PlaneSpecs and the detectors' workspace on
    the device."""

    _fields_ = [("n_planes", ctypes.c_int), ("record_time", ctypes.c_int),
                ("t_end", ctypes.c_void_p), ("accepted", ctypes.c_void_p),
                ("planes", ctypes.c_void_p), ("d", ctypes.c_void_p)]


def _plane_spec(plane, normal, out):
    """A PlaneSpec of one plane and its normal, writing to the tensors of
    `out`; NotImplementedError for a callable normal that is not a
    WarpedBasis (the kernel computes no other)."""
    r_in, r_out, theta_plane, opaque = plane
    spec = PlaneSpec(opaque=int(bool(opaque)), r_in=float(r_in),
                     r_out=float(r_out), plane_c=math.cos(theta_plane),
                     **{k: _ptr(out.get(k)) for k in (
                         "hits", "r", "phi", "xi", "t", "pr", "pth")})
    if isinstance(normal, WarpedBasis):
        spec.kind = 2
        spec.tilt, spec.sl, spec.cl = normal.tilt, normal.sl, normal.cl
        spec.warp_radius, spec.power = normal.warp_radius, normal.power
    elif callable(normal):
        raise NotImplementedError(
            "the CUDA plane recorder computes a flat basis or "
            "disk.warped_basis's warp; other callable normals run on the "
            "CPU's plain loop only")
    elif normal is not None:
        spec.kind = 1
        flat = [float(c) for vec in normal for c in vec]
        if len(flat) != 9:
            raise ValueError("a disk normal is ((n), (e1), (e2)), three "
                             "3-vectors")
        spec.basis[:] = flat
    return spec


def _trace_planes(metric, r_obs, alphas, thetas, theta_obs, lambda_max,
                  max_steps, planes, max_hits, precision, return_unconverged,
                  record_momentum, probe, cycle_exit, method, record_time,
                  multi, plane_list=False):
    """One launch of the plane-recorder instances (trace_disk_rays_cuda's
    route for tilted, warped and further planes, the time recorder and
    more than MAX_KERNEL_HITS slots): up to MAX_KERNEL_PLANES planes
    through a PlaneSet, more (or any number, with plane_list, which
    times the two against each other) through the broad instances'
    PlaneList. The slots start at 0 and the kernel writes each as it
    records it."""
    n = alphas.numel()
    dtype, dev = alphas.dtype, alphas.device
    outs = []
    for _plane, normal in planes:
        keys = (("r", "phi") + (("xi",) if normal is not None else ())
                + (("t",) if record_time else ())
                + (("pr", "pth") if record_momentum else ()))
        out = {k: torch.zeros(max_hits, n, dtype=dtype, device=dev)
               for k in keys}
        out["hits"] = torch.zeros(n, dtype=torch.int32, device=dev)
        outs.append(out)
    t_end = torch.empty(n, dtype=dtype, device=dev) if record_time else None
    specs = [_plane_spec(pl, nrm, out) for (pl, nrm), out in zip(planes,
                                                                outs)]
    if probe is not None:
        probe["accepted"] = torch.empty(n, dtype=torch.int32, device=dev)
    head = dict(n_planes=len(planes), record_time=int(bool(record_time)),
                t_end=_ptr(t_end),
                accepted=_ptr((probe or {}).get("accepted")))
    broad = plane_list or len(planes) > MAX_KERNEL_PLANES
    if broad:
        # the PlaneSpecs as bytes on the device, and the detectors' rows
        table = (PlaneSpec * len(specs))(*specs)
        spec_dev = to_device(torch.frombuffer(bytearray(table),
                                              dtype=torch.uint8), dev)
        work = torch.empty(2 * len(planes) * n, dtype=dtype, device=dev)
        pset = PlaneList(planes=spec_dev.data_ptr(), d=work.data_ptr(),
                         **head)
    else:
        pset = PlaneSet(**head)
        for k, spec in enumerate(specs):
            pset.planes[k] = spec
    res = _launch(metric, r_obs, alphas, thetas, theta_obs, lambda_max,
                  max_steps, precision, None,
                  (0.0, 0.0, math.pi / 2, 0, max_hits, record_momentum),
                  return_unconverged, probe, cycle_exit, method,
                  planes=pset)
    count_launch(trace_disk_rays_cuda, dtype, method,
                 "broad" if broad else "planes")

    def rows(out, k):
        return tuple(out[k].unbind(0)) if k in out else ()
    results = tuple(
        DiskTraceResult(res["status"], out["hits"], rows(out, "r"),
                        res["p_phi"], res["n_steps"], res["final_alpha"],
                        res["n_half"], rows(out, "phi"), rows(out, "xi"),
                        rows(out, "pr"), rows(out, "pth"), rows(out, "t"),
                        t_end if t_end is not None else ())
        for out in outs)
    result = results if multi else results[0]
    if return_unconverged:
        return result, res["flags"]
    return result


# Re-trace slots of the Kerr and disk two-pass drivers (the JAX package's
# default).
SLOTS = 8192


def _two_pass(trace, pass1_steps, max_steps, slots):
    """The recipe of every driver below. trace(pick, steps, **kw) is one
    single pass, capped at `steps` attempts, over pick(t) of each per-ray
    input t; the first pass also returns the mask of rays to re-trace."""
    res1, unconv = trace(lambda t: t, pass1_steps, return_unconverged=True)
    idx, dest = stragglers(unconv, slots)
    res2 = trace(lambda t: t[idx], max_steps)
    if isinstance(res1, tuple) and not hasattr(res1, "_fields"):
        return tuple(merge_results(a, b, dest) for a, b in zip(res1, res2))
    return merge_results(res1, res2, dest)


def trace_rays_kerr_two_pass(metric, r_obs, alphas, thetas, theta_obs,
                             axis_refine, lambda_max: float,
                             max_steps: int = 200000,
                             pass1_steps: int = 512, slots: int = SLOTS,
                             precision: str = "fast",
                             formulation: str = "theta", trace_fn=None,
                             method: str = "dp45",
                             event_interp: str = "hermite",
                             dynamic_params=None):
    """Straggler-robust tracing: a pass capped at `pass1_steps` attempts
    per ray, then a full-depth re-trace of the first `slots` rays still
    running. Returns TraceResult; see the module docstring. trace_fn:
    the single-pass tracer, trace_rays_kerr_cuda by default (the chip
    smoke test also drives the plain loop through it). dynamic_params:
    run-time (M, a) or (M, a, r_obs), carried through both passes."""
    trace_rays_kerr_two_pass.launches += 1
    trace_fn = trace_fn or trace_rays_kerr_cuda
    dyn = {} if dynamic_params is None else dict(
        dynamic_params=dynamic_params)
    return _two_pass(lambda pick, steps, **kw: trace_fn(
        metric, r_obs, pick(alphas), pick(thetas), theta_obs,
        pick(axis_refine), lambda_max, steps, precision=precision,
        formulation=formulation, method=method, event_interp=event_interp,
        **dyn, **kw), pass1_steps, max_steps, slots)


# Driver calls, so a run can show which path it took.
trace_rays_kerr_two_pass.launches = 0


def trace_rays_kerr_hybrid(metric, r_obs, alphas, thetas, theta_obs,
                           axis_refine, lambda_max: float,
                           max_steps: int = 200000,
                           event_interp: str = "hermite",
                           s_thresh: float = 1e-3, slots: int | None = None,
                           pass1_steps: int | None = None,
                           precision: str = "fast", method: str = "dp45",
                           trace_fn=None, probe: dict | None = None,
                           dynamic_params=None):
    """The mu-chart tracer with the JAX Pallas backend's semantics (its
    trace_rays_kerr_hybrid with backend="pallas"); returns TraceResult.

      1. the first `slots` pole-risk rays (metric.pole_risk at s_thresh;
         slots as ops.kerr_trace.hybrid_slots sizes them) are poisoned:
         pass A starts them INVALID (force_invalid);
      2. pass A traces every ray in mu, capped at pass1_steps attempts
         (max_steps when None), returning its unconverged rays;
      3. the poisoned, INVALID and unconverged rays, the first `slots` of
         them in index order, are gathered, re-traced in theta at full
         depth (pass B, the theta instance) and scattered back.

    n_steps is the sum of both passes. A nearly polar observer
    (|sin theta_obs| < 0.1) is one full-depth theta trace. trace_fn: the
    single-pass tracer, trace_rays_kerr_cuda by default, so CPU tensors
    run the plain loop with these semantics (the chip smoke test drives
    the plain loop on the card through it too). probe: a dict that
    receives the "poison", "redo" and pass A's "unconverged" masks
    (device tensors, no sync). dynamic_params: run-time (M, a) or (M, a,
    r_obs) of the sequences, float32 only: the pole risk uses the
    TracedKerr metric and the run-time radius, and both passes take them
    (as the JAX Pallas backend's SMEM scalars); lambda_max stays the
    caller's, for the largest radius of a sweep.
    The plain version with the XLA backend's semantics (no cap, no
    unconverged set) is ops.kerr_trace.trace_rays_kerr_hybrid.
    """
    trace_rays_kerr_hybrid.launches += 1
    trace_fn = trace_fn or trace_rays_kerr_cuda
    kw = dict(precision=precision, method=method, event_interp=event_interp)
    if dynamic_params is not None:
        kw["dynamic_params"] = dynamic_params
    if abs(math.sin(float(theta_obs))) < POLAR_OBSERVER_SIN:
        return trace_fn(metric, r_obs, alphas, thetas, theta_obs,
                        axis_refine, lambda_max, max_steps, **kw)
    slots = hybrid_slots(alphas.numel(), slots)
    risk_metric, risk_r = traced_scalars(metric, r_obs, dynamic_params,
                                         alphas.dtype)
    poison = hybrid_poison(risk_metric, risk_r, alphas, thetas, theta_obs,
                           slots, s_thresh)
    p1 = max_steps if pass1_steps is None else min(pass1_steps, max_steps)
    res_a, unconv = trace_fn(metric, r_obs, alphas, thetas, theta_obs,
                             axis_refine, lambda_max, p1, formulation="mu",
                             force_invalid=poison, return_unconverged=True,
                             **kw)
    redo = poison | (res_a.status == INVALID) | unconv
    idx, dest = stragglers(redo, slots)
    res_b = trace_fn(metric, r_obs, alphas[idx], thetas[idx], theta_obs,
                     axis_refine[idx], lambda_max, max_steps, **kw)
    if probe is not None:
        probe.update(poison=poison, redo=redo, unconverged=unconv)
    return merge_results(res_a, res_b, dest)


trace_rays_kerr_hybrid.launches = 0


def trace_disk_rays_two_pass(metric, r_obs, alphas, thetas, theta_obs,
                             lambda_max: float, max_steps: int, disk_plane,
                             max_disk_hits: int = 2, pass1_steps: int = 512,
                             slots: int = SLOTS, precision: str = "fast",
                             formulation: str = "theta",
                             record_momentum: bool = False, trace_fn=None,
                             method: str = "dp45", disk_normal=None,
                             extra_disks=None, record_time: bool = False):
    """trace_rays_kerr_two_pass's recipe over the disk variant: the
    re-traced rays bring back their whole record (status, hits, heading,
    crossing times and t_end). Returns DiskTraceResult (with extra_disks,
    a tuple of them, each plane merged alike). trace_fn: the single-pass
    tracer, trace_disk_rays_cuda by default."""
    trace_disk_rays_two_pass.launches += 1
    trace_fn = trace_fn or trace_disk_rays_cuda
    extra = dict(disk_normal=disk_normal, extra_disks=extra_disks,
                 record_time=record_time)
    extra = {k: v for k, v in extra.items() if v}
    return _two_pass(lambda pick, steps, **kw: trace_fn(
        metric, r_obs, pick(alphas), pick(thetas), theta_obs, lambda_max,
        steps, disk_plane, max_disk_hits, precision=precision,
        formulation=formulation, record_momentum=record_momentum,
        method=method, **extra, **kw), pass1_steps, max_steps, slots)


trace_disk_rays_two_pass.launches = 0


def trace_rays_volumetric_two_pass(metric, r_obs, alphas, thetas,
                                   theta_obs, emission_fn,
                                   lambda_max: float,
                                   max_steps: int = 200000,
                                   precision: str = "fast",
                                   method: str = "dp45", absorption_fn=None,
                                   pass1_steps: int = 4096,
                                   slots: int = 1024, sat_window: int = 0,
                                   trace_fn=None):
    """The two-pass recipe over the volumetric trace: the re-trace
    restarts every path integral from lambda = 0, so the merge is exact.
    Rays ended by the saturation or frozen-state exit read as finished
    and are not re-traced. Returns VolumetricResult. trace_fn: the
    single-pass tracer, volumetric_kernel.trace_rays_volumetric_cuda by
    default."""
    from light_path_tracer_tpu_torch.ops.cuda.volumetric_kernel import (
        trace_rays_volumetric_cuda)
    trace_rays_volumetric_two_pass.launches += 1
    trace_fn = trace_fn or trace_rays_volumetric_cuda
    return _two_pass(lambda pick, steps, **kw: trace_fn(
        metric, r_obs, pick(alphas), pick(thetas), theta_obs, emission_fn,
        lambda_max, steps, precision=precision, method=method,
        absorption_fn=absorption_fn, sat_window=sat_window, **kw),
        pass1_steps, max_steps, slots)


trace_rays_volumetric_two_pass.launches = 0


def trace_rays_aux_two_pass(metric, r_obs, alphas, thetas, theta_obs,
                            transfer_fn, n_extras: int, aux,
                            lambda_max: float, max_steps: int = 200000,
                            precision: str = "fast", method: str = "dp45",
                            pass1_steps: int = 4096, slots: int = 1024,
                            sat_window: int = 0, sat_monitor: tuple = (),
                            trace_fn=None):
    """The two-pass recipe over the generic coupled-extras trace (the
    re-traced rays take their aux values along). Returns ExtrasResult.
    trace_fn: the single-pass tracer,
    volumetric_kernel.trace_rays_aux_cuda by default."""
    from light_path_tracer_tpu_torch.ops.cuda.volumetric_kernel import (
        trace_rays_aux_cuda)
    trace_rays_aux_two_pass.launches += 1
    trace_fn = trace_fn or trace_rays_aux_cuda
    aux = tuple(aux) if aux is not None else ()
    return _two_pass(lambda pick, steps, **kw: trace_fn(
        metric, r_obs, pick(alphas), pick(thetas), theta_obs, transfer_fn,
        n_extras, tuple(pick(a) for a in aux), lambda_max, steps,
        precision=precision, method=method, sat_window=sat_window,
        sat_monitor=sat_monitor, **kw), pass1_steps, max_steps, slots)


trace_rays_aux_two_pass.launches = 0


def trace_rays_spectral_two_pass(metric, r_obs, alphas, thetas, theta_obs,
                                 transfer_fn, n_bands: int,
                                 lambda_max: float, max_steps: int = 200000,
                                 precision: str = "fast",
                                 method: str = "dp45",
                                 pass1_steps: int = 4096, slots: int = 1024,
                                 sat_window: int = 0,
                                 sat_monitor: tuple = None, trace_fn=None):
    """The two-pass recipe over the spectral trace; returns
    SpectralResult. sat_monitor defaults to the n bands. trace_fn: the
    single-pass spectral tracer, volumetric_kernel.trace_rays_spectral_cuda
    by default."""
    from light_path_tracer_tpu_torch.ops.cuda.volumetric_kernel import (
        trace_rays_spectral_cuda)
    trace_rays_spectral_two_pass.launches += 1
    trace_fn = trace_fn or trace_rays_spectral_cuda
    return _two_pass(lambda pick, steps, **kw: trace_fn(
        metric, r_obs, pick(alphas), pick(thetas), theta_obs, transfer_fn,
        n_bands, lambda_max, steps, precision=precision, method=method,
        sat_window=sat_window, sat_monitor=sat_monitor, **kw),
        pass1_steps, max_steps, slots)


trace_rays_spectral_two_pass.launches = 0
