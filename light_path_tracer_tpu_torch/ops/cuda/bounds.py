"""Lower bounds of the port's ray kernels on the card: the work a launch
must do, counted from the CUDA sources, over the rates the card reaches.

Two bounds stand beside each kernel's time (chip_smoke.py,
scripts/torch_kernel_study.py):

- the flops-only bound, `flops_bound_ms`: this run's per-ray attempts
  times the flops of one attempt as first counted (`attempt_flops`:
  a multiply-add 2, a division 1, sin, cos, exp, pow and sqrt left out)
  over the published FP32 (FP64) peak, or the bytes over 3.35 TB/s where
  that is larger. Its constants stay as they were, so its readings
  compare across versions of the kernels.
- the counted bound, `counted_bound_ms`: every operation of one attempt
  by kind (`KINDS`), read from the sources (`attempt_ops`), times the
  attempts, each kind over the rate the peak probe (ops/cuda/peak_probe.py)
  measured for it on this card, summed; or the bytes, where larger. The
  kernels build without FMA contraction (-fmad=false), so every add, sub
  and mul issues one instruction: a "flop" counts at an FMA's instruction
  rate, half the published FP32 (FP64) peak, or half the probe's FMA rate
  where that reads higher (`PUBLISHED_FLOP`). A division and sqrt are
  IEEE sequences, sin, cos, exp and pow libdevice ones, which have no
  published rate: each counts at its own measured eight-chain throughput
  (sin and cos of small arguments, as the kernels take them).

How the sources are counted: every add, sub and mul of one evaluation as
written, once per function (an expression a function repeats verbatim
counts once; one that two functions both compute counts in each);
products of launch constants alone (a^2, 2 M, 2 M a) count nothing, the
compiler forms them once; a negation, abs, max, min, clip, compare,
select and floor count nothing, nor do integer work, loads and stores.
Events (the Hermite crossing of a captured or escaping step, the disk
variant's plane test) happen on few attempts and are left out. So the
counted bound leaves work out and stays a lower bound, unless the
compiler merges more of what two functions repeat than these counts
allow for.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PEAK_FP32", "PEAK_FP64", "PEAK_BYTES", "PUBLISHED_FLOP",
           "RHS5_FLOPS",
           "SOURCE_FLOPS", "ORBIT_STEP_FLOPS", "KINDS", "RATE_FORMS",
           "GEODESIC", "Work", "form_flops", "attempt_flops", "source_ops",
           "transfer_ops", "rhs_ops", "attempt_ops", "extras_work",
           "kerr_work", "orbit_work", "components", "flops_bound_ms",
           "counted_bound_ms"]

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 and
# float64 outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
# A flop's instruction rate at those peaks (an FMA is two flops): the
# counted bound never prices a flop below it.
PUBLISHED_FLOP = {"float32": PEAK_FP32 / 2, "float64": PEAK_FP64 / 2}

# The flops-only count: one evaluation as written, before the
# compiler's common subexpressions, a multiply-add 2, a division 1, the
# library functions left out: the geodesic's rhs5 (kerr_dp45_common.cuh),
# the emissivity and redshift every transfer form shares (source() in
# kerr_dp45_extras.cuh) and what each form adds (form_flops); one RK4 step
# of the orbit kernel.
RHS5_FLOPS = 148
SOURCE_FLOPS = 67
ORBIT_STEP_FLOPS = 55


def form_flops(kind, width=0, absorbing=False):
    """The extras' flops of one RHS evaluation of a transfer form
    (flops-only count)."""
    extra = {"thin": 0, "absorbed": 6, "spectral": 5 + 3 * width,
             "stokes": 240, "movie": 33 + 9 * width,
             "order": 15 + width}[kind]
    if absorbing and kind in ("movie", "order"):
        extra += 7
    return SOURCE_FLOPS + extra


def attempt_flops(components, rhs_extra=0):
    """Flops of one DP45 attempt over `components` state components: six
    new RHS evaluations plus the stage sums, the error norm, the event
    root and the controller (86 C + 55, the structure
    scripts/roofline.py documents)."""
    return 6 * (RHS5_FLOPS + rhs_extra) + 86 * components + 55


# ---- the counted bound ---------------------------------------------------

KINDS = ("flop", "div", "sqrt", "sin", "cos", "exp", "pow")
# kind -> (the peak probe's form that times it, operations per counted
# unit of that form's rate): a flop at the FMA chain's instruction rate,
# raised to PUBLISHED_FLOP where the chain reads below it.
RATE_FORMS = {
    "float32": dict(flop=("fma32x8", 0.5), div=("div32x8", 1.0),
                    sqrt=("sqrt32x8", 1.0), sin=("sin32x8", 1.0),
                    cos=("cos32x8", 1.0), exp=("exp32x8", 1.0),
                    pow=("pow32x8", 1.0)),
    "float64": dict(flop=("fma64", 0.5), div=("div64x8", 1.0),
                    sqrt=("sqrt64x8", 1.0), sin=("sin64x8", 1.0),
                    cos=("cos64x8", 1.0), exp=("exp64x8", 1.0),
                    pow=("pow64x8", 1.0))}


def _ops(**counts):
    return {k: counts.get(k, 0) for k in KINDS}


def _add(*parts):
    return {k: sum(p.get(k, 0) for p in parts) for k in KINDS}


def _times(n, ops):
    return {k: n * ops.get(k, 0) for k in KINDS}


# rhs5_trig of kerr_dp45_common.cuh with its sin and cos (rhs5 computes
# them; the extras kernel computes them once and hands them on).
GEODESIC = _ops(flop=117, div=3, sin=1, cos=1)

# j_rest (kerr_dp45_extras.cuh) by profile.
_EMISSIVITY = {
    "torus": _ops(flop=4, div=2, exp=1),
    "powerlaw": _ops(flop=2, div=2, exp=1, pow=1),
    "jet": _ops(flop=6, div=4, exp=2, pow=1),
    "shell": _ops(flop=5, div=4, exp=2),
}
# g_circular and g_jet: the emitter's redshift.
_G_CIRCULAR = _ops(flop=37, div=7, pow=1, sqrt=1)
_G_JET = _ops(flop=22, div=7, sqrt=2)


def source_ops(profile="torus", geometry=False):
    """source() of one evaluation: the emissivity, and unless in the pure
    geometry mode (g_power 0) the redshift (the jet's own flow for the jet
    profile, the circular one otherwise), w = g^p and em = j w."""
    ops = _EMISSIVITY[profile]
    if geometry:
        return dict(ops)
    g = _G_JET if profile == "jet" else _G_CIRCULAR
    return _add(ops, g, _ops(flop=1, pow=1))


def transfer_ops(kind, width=0, absorbing=False, field="toroidal",
                 geometry=False):
    """What a transfer functor adds to source() in one evaluation (the
    functors of kerr_dp45_extras.cu, kerr_dp45_stokes.cu,
    kerr_dp45_movie.cuh and kerr_dp45_orders.cu); width is the bands,
    frames or orders."""
    opacity = _ops(flop=1) if geometry else _ops(flop=1, div=1)
    screen = _ops(flop=1, exp=1)        # exp(-max(tau, -30)) times a term
    if kind == "thin":
        return _ops()
    if kind == "absorbed":
        return _add(screen, opacity)
    if kind == "spectral":
        d0 = _ops(flop=1) if geometry else _ops(flop=2, pow=1)
        return _add(d0, _times(width, _ops(flop=3, exp=1)))
    if kind == "movie":
        base = _ops(flop=22, div=2)
        frames = _times(width, _ops(flop=9, div=1, exp=1, cos=1))
        return _add(base, frames, *((screen, opacity) if absorbing else ()))
    if kind == "order":
        base = _ops(flop=9, div=1, exp=1)
        return _add(base, *((screen, opacity) if absorbing else ()))
    if kind == "stokes":
        # the vertical field's b_theta adds a division
        return _ops(flop=183, div=18 + (field == "vertical"), pow=1,
                    sqrt=3)
    raise ValueError(f"unknown transfer form {kind!r}")


def rhs_ops(kind, width=0, absorbing=False, profile="torus",
            field="toroidal", geometry=False):
    """One evaluation of the extras kernel's right-hand side: the geodesic
    (its sin and cos shared with the transfer function), source() and the
    functor."""
    return _add(GEODESIC, source_ops(profile, geometry),
                transfer_ops(kind, width, absorbing, field, geometry))


def attempt_ops(n_components, rhs, dtype="float32"):
    """One DP45 attempt over n_components state components with `rhs` the
    operations of one evaluation: six new evaluations; per component the
    stage sums (46 flops), the error scale (4 in float32, whose scale is
    increment-aware, 2 in float64), the error estimate (12), its ratio to
    the scale (a division) and its square's sum (2); then the norm (a
    division and a sqrt), h_eff, the controller's pow and its three
    candidate steps, and lambda's update (7 flops)."""
    per = 64 if dtype == "float32" else 62
    return _add(_times(6, rhs), _times(n_components, _ops(flop=per, div=1)),
                _ops(flop=7, div=1, sqrt=1, pow=1))


def components(kind, width=0, absorbing=False):
    """The state's components of a transfer form: five, then the extras."""
    return 5 + {"thin": 1, "absorbed": 2, "spectral": 1 + width,
                "stokes": 3, "movie": 1 + int(absorbing) + width,
                "order": 1 + int(absorbing) + width}[kind]


@dataclasses.dataclass(frozen=True)
class Work:
    """The work of one unit (an attempt, an RK4 step) or, multiplied by a
    count, of a launch: `flops` as the flops-only bound counts them, `ops`
    by kind as the counted bound does, in scalar type `dtype`."""

    flops: int
    ops: dict
    dtype: str = "float32"

    def __rmul__(self, count):
        return Work(count * self.flops, _times(count, self.ops), self.dtype)


def extras_work(kind, width=0, absorbing=False, profile="torus",
                field="toroidal", dtype="float32"):
    """One attempt of the extras kernel for a transfer form. The
    flops-only count takes the jet as the thin form, as it always did."""
    n = components(kind, width, absorbing)
    flops = attempt_flops(n, form_flops(kind, width, absorbing))
    return Work(flops, attempt_ops(
        n, rhs_ops(kind, width, absorbing, profile, field), dtype), dtype)


def kerr_work(dtype="float32"):
    """One attempt of the Kerr shadow or disk kernel (kerr_dp45.cu)."""
    return Work(attempt_flops(5), attempt_ops(5, GEODESIC, dtype), dtype)


def orbit_work(charged=False, dtype="float32"):
    """One RK4 step of the orbit kernel (schwarzschild_rk4.cu): four
    evaluations of w' (3 flops; 6 with the charge term), the stages and
    sums, h / 6, and the step's update of w and phi."""
    return Work(ORBIT_STEP_FLOPS, _ops(flop=57 if charged else 45, div=1),
                dtype)


def flops_bound_ms(work, n_bytes, peak=None):
    """The flops-only bound of a launch doing `work` (a total) and moving
    n_bytes: (ms, "operations" or "bytes")."""
    if peak is None:
        peak = PEAK_FP64 if work.dtype == "float64" else PEAK_FP32
    t_ops, t_bytes = work.flops / peak, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def counted_bound_ms(work, n_bytes, rates):
    """The counted bound of a launch doing `work` (a total) and moving
    n_bytes, at `rates` (peak_probe.measure_rates: {form: {"rate"}}), a
    flop at no less than PUBLISHED_FLOP: (ms, "operations" or "bytes",
    {kind: ms})."""
    by_kind = {}
    for kind, (form, per) in RATE_FORMS[work.dtype].items():
        count = work.ops.get(kind, 0)
        if count:
            rate = per * rates[form]["rate"]
            if kind == "flop":
                rate = max(rate, PUBLISHED_FLOP[work.dtype])
            by_kind[kind] = 1e3 * count / rate
    t_ops, t_bytes = sum(by_kind.values()), 1e3 * n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), by_kind
