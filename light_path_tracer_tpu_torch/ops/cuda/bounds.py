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

Both embedded pairs are counted (`method`): a DP45 attempt makes six new
RHS evaluations, a DOP853 attempt twelve (eleven stages and the end
stage, csrc/kerr_dop853.cuh), whose stage and estimator sums are read
from the nonzeros of the DOP853 tableau (`dop853_sum_flops`). Both charts
of the Kerr kernel are counted (`chart`): the mu chart's RHS (rhs5_mu)
calls no sin or cos; its state conversions run once a ray, as the
initial conditions do, and are left out. The extras kernel's Kerr-Newman
flow (`family`) adds the charge to W and Delta and takes the charged
Keplerian Omega, a sqrt in place of the pow.

The broad extras instances (csrc/kerr_broad_extras.cuh: spectra, movies
and order decompositions of any width) do less of a wide component's
work than a narrow instance would: its stage arguments are never formed
and its stage-2 slope (which neither DP45 sum reads) never taken
(`broad_work`), and they move its state through device memory, four
scalars a component an attempt (`broad_state_bytes`): a floor of that
design beside the contract's bound, which counts each input read and
each output written once.
"""

from __future__ import annotations

import dataclasses

from light_path_tracer_tpu_torch.ops import tableau as tb

__all__ = ["PEAK_FP32", "PEAK_FP64", "PEAK_BYTES", "PUBLISHED_FLOP",
           "RHS5_FLOPS", "GEODESIC_FAMILIES",
           "SOURCE_FLOPS", "ORBIT_STEP_FLOPS", "KINDS", "RATE_FORMS",
           "DP45_SUM_FLOPS", "dop853_sum_flops", "rhs_evaluations",
           "GEODESIC", "MU_GEODESIC_FAMILIES", "Work", "form_flops",
           "attempt_flops", "source_ops",
           "transfer_ops", "rhs_ops", "attempt_ops", "extras_work",
           "broad_work", "broad_state_bytes", "kerr_work", "planes_work",
           "orbit_work", "components",
           "flops_bound_ms", "counted_bound_ms"]

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


# DP45's stage and solution sums a component: its five rows' left folds,
# each times h plus y, and y5's (attempt_ops' 46).
DP45_SUM_FLOPS = 46


def dop853_sum_flops():
    """Flops of one DOP853 attempt's sums a component, from the nonzeros
    of the tableau: each stage row's left fold (m products, m - 1 sums),
    times h, plus y; the solution's and both estimators' running sums
    (a product a weight, a sum a weight after the first); y + h times the
    solution's. 158 for ops/tableau.py's D853_A, D853_B, D853_E5 and
    D853_E3."""
    rows = sum(2 * len(row) + 1 for row in tb.D853_A[1:])
    sums = sum(2 * len(w) - 1 for w in (tb.D853_B, tb.D853_E5, tb.D853_E3))
    return rows + sums + 2


def rhs_evaluations(method="dp45"):
    """New RHS evaluations of one attempt: DP45's six stages, DOP853's
    eleven stages and its end stage (FSAL keeps the first of both)."""
    return {"dp45": 6, "dop853": len(tb.D853_A) - 1 + 1}[method]


def attempt_flops(components, rhs_extra=0, method="dp45"):
    """Flops of one attempt over `components` state components: the
    pair's new RHS evaluations plus the stage sums, the error norm, the
    event root and the controller (DP45: 86 C + 55, the structure
    scripts/roofline.py documents; DOP853: its own sums in place of
    DP45's, and a second estimator's division and square a component and
    the combined norm's 4 flops)."""
    rhs = rhs_evaluations(method) * (RHS5_FLOPS + rhs_extra)
    if method == "dop853":
        return (rhs + (86 - DP45_SUM_FLOPS + dop853_sum_flops() + 3)
                * components + 55 + 4)
    return rhs + 86 * components + 55


# ---- the counted bound ---------------------------------------------------

KINDS = ("flop", "div", "sqrt", "sin", "cos", "exp", "pow", "atan2")
# kind -> (the peak probe's form that times it, operations per counted
# unit of that form's rate): a flop at the FMA chain's instruction rate,
# raised to PUBLISHED_FLOP where the chain reads below it.
RATE_FORMS = {
    "float32": dict(flop=("fma32x8", 0.5), div=("div32x8", 1.0),
                    sqrt=("sqrt32x8", 1.0), sin=("sin32x8", 1.0),
                    cos=("cos32x8", 1.0), exp=("exp32x8", 1.0),
                    pow=("pow32x8", 1.0), atan2=("atan232x8", 1.0)),
    "float64": dict(flop=("fma64", 0.5), div=("div64x8", 1.0),
                    sqrt=("sqrt64x8", 1.0), sin=("sin64x8", 1.0),
                    cos=("cos64x8", 1.0), exp=("exp64x8", 1.0),
                    pow=("pow64x8", 1.0), atan2=("atan264x8", 1.0))}


def _ops(**counts):
    return {k: counts.get(k, 0) for k in KINDS}


def _add(*parts):
    return {k: sum(p.get(k, 0) for p in parts) for k in KINDS}


def _times(n, ops):
    return {k: n * ops.get(k, 0) for k in KINDS}


# rhs5_trig of kerr_dp45_common.cuh with its sin and cos (rhs5 computes
# them; the extras kernel computes them once and hands them on).
GEODESIC = _ops(flop=117, div=3, sin=1, cos=1)
# The RHS of each metric family of the Kerr kernel: Kerr-Newman adds Q^2
# to Delta, forms W = 2 M r - Q^2 (2 flops) and has one more product in
# d g^tphi / dr; Johannsen-Psaltis runs rhs5_jp, the covariant partials
# (52 flops, 12 divisions) and the 2x2 block-inverse chain with
# Hamilton's equations (118 flops, 11 divisions).
GEODESIC_FAMILIES = {
    "kerr": GEODESIC,
    "kerr_newman": _add(GEODESIC, _ops(flop=4)),
    "johannsen_psaltis": _ops(flop=170, div=23, sin=1, cos=1),
}

# rhs5_mu of kerr_dp45_common.cuh, the mu chart's RHS (Kerr and
# Kerr-Newman): 28 flops and three reciprocals for the metric terms and
# the velocities, 49 for the radial and 41 for the polar derivatives, no
# sin or cos; Kerr-Newman adds what it adds to rhs5_trig.
MU_GEODESIC_FAMILIES = {
    "kerr": _ops(flop=118, div=3),
    "kerr_newman": _ops(flop=122, div=3),
}

# j_rest (kerr_dp45_extras.cuh) by profile.
_EMISSIVITY = {
    "torus": _ops(flop=4, div=2, exp=1),
    "powerlaw": _ops(flop=2, div=2, exp=1, pow=1),
    "jet": _ops(flop=6, div=4, exp=2, pow=1),
    "shell": _ops(flop=5, div=4, exp=2),
}
# g_circular and g_jet: the emitter's redshift, by family. Kerr-Newman's
# flow subtracts Q^2 from W and adds it to Delta (flow_W, flow_Delta: 2
# flops), and its Keplerian Omega (kepler_omega) is kep_num x / (r^2 +
# kep_add x) with x = sqrt(max(M r - Q^2, 0)): 5 flops, a sqrt and a
# division against Kerr's add, pow and division.
_G_CIRCULAR = {"kerr": _ops(flop=37, div=7, pow=1, sqrt=1),
               "kerr_newman": _ops(flop=43, div=7, sqrt=2)}
_G_JET = {"kerr": _ops(flop=22, div=7, sqrt=2),
          "kerr_newman": _ops(flop=24, div=7, sqrt=2)}


def source_ops(profile="torus", geometry=False, family="kerr"):
    """source() of one evaluation: the emissivity, and unless in the pure
    geometry mode (g_power 0) the redshift (the jet's own flow for the jet
    profile, the circular one otherwise) of the family's flow, w = g^p and
    em = j w."""
    ops = _EMISSIVITY[profile]
    if geometry:
        return dict(ops)
    g = (_G_JET if profile == "jet" else _G_CIRCULAR)[family]
    return _add(ops, g, _ops(flop=1, pow=1))


def transfer_ops(kind, width=0, absorbing=False, field="toroidal",
                 geometry=False, family="kerr"):
    """What a transfer functor adds to source() in one evaluation (the
    functors of kerr_dp45_extras.cu, kerr_dp45_stokes.cu,
    kerr_dp45_movie.cuh and kerr_dp45_orders.cu); width is the bands,
    frames or orders. Kerr-Newman's movie adds Q^2 to its tdot's Delta
    and subtracts it from 2 M r (2 flops)."""
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
        base = _ops(flop=22 + (2 if family == "kerr_newman" else 0), div=2)
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
            field="toroidal", geometry=False, family="kerr"):
    """One evaluation of the extras kernel's right-hand side in a family
    ("kerr" or "kerr_newman"): the geodesic (its sin and cos shared with
    the transfer function), source() and the functor."""
    return _add(GEODESIC_FAMILIES[family],
                source_ops(profile, geometry, family),
                transfer_ops(kind, width, absorbing, field, geometry,
                             family))


def attempt_ops(n_components, rhs, dtype="float32", method="dp45"):
    """One attempt over n_components state components with `rhs` the
    operations of one evaluation. DP45: six new evaluations; per
    component the stage sums (46 flops), the error scale (4 in float32,
    whose scale is increment-aware, 2 in float64), the error estimate
    (12), its ratio to the scale (a division) and its square's sum (2);
    then the norm (a division and a sqrt), h_eff, the controller's pow
    and its three candidate steps, and lambda's update (7 flops). DOP853:
    twelve new evaluations; per component its sums (dop853_sum_flops),
    the error scale (float32's running maximum over the stages counts
    nothing), both estimators' ratios (two divisions) and squares' sums
    (4); then the combined norm (4 flops, a division and a sqrt) and the
    same controller and lambda update."""
    scale = 4 if dtype == "float32" else 2
    if method == "dop853":
        per = _ops(flop=dop853_sum_flops() + scale + 4, div=2)
        return _add(_times(rhs_evaluations(method), rhs),
                    _times(n_components, per),
                    _ops(flop=7 + 4, div=1, sqrt=1, pow=1))
    per = DP45_SUM_FLOPS + scale + 12 + 2
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

    def __add__(self, other):
        """The work of two launches in one scalar type (a driver's two
        passes)."""
        if other.dtype != self.dtype:
            raise ValueError(f"adding {other.dtype} work to {self.dtype}")
        return Work(self.flops + other.flops, _add(self.ops, other.ops),
                    self.dtype)


def _extra_flops(ops, base):
    """The flops and divisions of `ops` beyond `base`'s (the flops-only
    count's share of a family or chart)."""
    return (ops["flop"] + ops["div"]) - (base["flop"] + base["div"])


def extras_work(kind, width=0, absorbing=False, profile="torus",
                field="toroidal", dtype="float32", method="dp45",
                family="kerr"):
    """One attempt of the extras kernel for a transfer form, embedded pair
    and family ("kerr" or "kerr_newman"). The flops-only count takes the
    jet as the thin form, as it always did, and adds a family's flops and
    divisions beyond Kerr's."""
    n = components(kind, width, absorbing)
    rhs = rhs_ops(kind, width, absorbing, profile, field, family=family)
    extra = _extra_flops(rhs, rhs_ops(kind, width, absorbing, profile,
                                      field))
    flops = attempt_flops(n, form_flops(kind, width, absorbing) + extra,
                          method)
    return Work(flops, attempt_ops(n, rhs, dtype, method), dtype)


def _width_slope_ops(kind, absorbing=False, family="kerr"):
    """One wide component's slope from an evaluation's shared terms: a
    band's, a frame's or an order's share of transfer_ops."""
    return _add(transfer_ops(kind, 1, absorbing, family=family),
                {k: -v for k, v in transfer_ops(kind, 0, absorbing,
                                                family=family).items()})


def broad_work(kind, width, absorbing=False, profile="torus",
               dtype="float32", method="dp45", family="kerr"):
    """One attempt of a broad extras instance (kind "spectral", "movie"
    or "order") of `width` bands, frames or orders: the core (the
    geodesic and the leading extras, 5 + 1 or 2 components) as
    extras_work counts a narrow form at width 0, and a wide component's
    slope at each stage its sums read (DP45: stages 3 to 7; DOP853: all
    twelve new ones), its solution sum (y + h times the B sum), its error
    sums (DP45: the E sum; DOP853: the E5 and E3 sums) and its error
    scale, ratios and squares. The flops-only count is the ops' flops and
    divisions."""
    core_n = components(kind, 0, absorbing)
    core = attempt_ops(core_n, rhs_ops(kind, 0, absorbing, profile,
                                       family=family), dtype, method)
    scale = 4 if dtype == "float32" else 2
    slope = _width_slope_ops(kind, absorbing, family)
    if method == "dop853":
        sums = sum(2 * len(w) - 1 for w in (tb.D853_B, tb.D853_E5,
                                            tb.D853_E3)) + 2
        per = _add(_times(rhs_evaluations(method), slope),
                   _ops(flop=sums + scale + 4, div=2))
    else:
        # y5: five products, four sums, h and y; E: six, five and h
        per = _add(_times(5, slope), _ops(flop=11 + 12 + scale + 2, div=1))
    ops = _add(core, _times(width, per))
    return Work(ops["flop"] + ops["div"], ops, dtype)


def broad_state_bytes(width, dtype="float32"):
    """The bytes a broad instance moves a ray an attempt for its wide
    state in device memory: each component's value and slope read, its
    solution and end slope written."""
    return 4 * width * (8 if dtype == "float64" else 4)


def kerr_work(dtype="float32", family="kerr", method="dp45", chart="theta"):
    """One attempt of the Kerr shadow or disk kernel (kerr_dp45.cu, and
    its DOP853 instances) for a metric family of GEODESIC_FAMILIES, an
    embedded pair and a chart ("theta", or "mu" for the families of
    MU_GEODESIC_FAMILIES). The flops-only count adds the family's and
    chart's flops and divisions beyond Kerr's theta RHS to RHS5_FLOPS."""
    geo = (MU_GEODESIC_FAMILIES if chart == "mu"
           else GEODESIC_FAMILIES)[family]
    return Work(attempt_flops(5, _extra_flops(geo, GEODESIC), method),
                attempt_ops(5, geo, dtype, method), dtype)


# The surface kernel's time component (csrc/kerr_surface.cuh tdot): Kerr
# and Kerr-Newman as the plane recorder's tdot; Johannsen-Psaltis's
# inverse_metric_jp for its two entries (30 flops, 7 divisions).
_SURFACE_TDOT = {"kerr": _ops(flop=18, div=2),
                 "kerr_newman": _ops(flop=21, div=2),
                 "johannsen_psaltis": _ops(flop=30, div=7)}


def surface_work(dtype="float32", family="kerr", method="dp45",
                 record_time=False):
    """One attempt of the surface kernel (csrc/kerr_surface.cuh): the
    Kerr kernel's attempt over 5 components (kerr_work), or over 6 with
    the coordinate time, whose rate adds to each evaluation."""
    geo = GEODESIC_FAMILIES[family]
    if not record_time:
        return kerr_work(dtype, family, method)
    rhs = _add(geo, _SURFACE_TDOT[family])
    return Work(attempt_flops(6, _extra_flops(rhs, GEODESIC), method),
                attempt_ops(6, rhs, dtype, method), dtype)


# The plane recorder (csrc/kerr_planes.cuh). An accepted attempt takes
# one set of sines and cosines at its end (Trig: cos theta; sin theta
# for a tilted plane or the time recorder; sin and cos phi for a tilted
# plane), each plane's detector there (kind 0: a subtraction; a normal:
# n . xhat, 7 flops; a warp adds n's basis: two divisions, a pow, a sin,
# a cos and 3 flops) and the sign test's product, and with the time
# recorder one tdot (18 flops, 2 divisions) and the trapezoid (4 flops):
# the detectors and tdot at the start are the previous attempt's, which
# the lane carries. A recorded crossing takes its own sines and cosines
# (sin theta; cos theta for a normal or the time recorder; phi's for a
# normal), then kind 0's azimuth (1 flop) or a normal's in-plane
# azimuth and xi (25 flops, a division for the cotangent, an atan2; a
# warp's basis at the crossing adds two divisions, a pow, a sin, a cos
# and 5 flops), and with the time recorder tdot and t (22 flops, 2
# divisions). The crossing's location (the root fraction and the
# interpolation) is not counted.
_DETECTOR = {0: _ops(flop=1), 1: _ops(flop=7),
             2: _ops(flop=10, div=2, pow=1, sin=1, cos=1)}
_AZIMUTH = {0: _ops(flop=1), 1: _ops(flop=25, div=1, atan2=1),
            2: _ops(flop=30, div=3, pow=1, sin=1, cos=1, atan2=1)}
_TDOT = _ops(flop=18, div=2)


def _trig(sin_theta, cos_theta, phi):
    """The library calls of one Trig: the sines and cosines taken."""
    return _ops(sin=int(sin_theta) + int(phi),
                cos=int(cos_theta) + int(phi))


def planes_work(kinds, record_time=False, dtype="float32"):
    """(the work of one accepted attempt, the work of one recorded
    crossing on each plane) the plane recorder adds to the disk
    variant's attempt (kerr_work), for planes of `kinds` (0 equatorial, 1
    flat tilted, 2 warp): what bounds the plane-recorder instances with
    the probe's accepted attempts and each plane's recorded crossings of
    the run."""
    tilted = any(kinds)
    step = _add(_trig(tilted or record_time, True, tilted),
                *(_add(_DETECTOR[k], _ops(flop=1)) for k in kinds),
                *((_TDOT, _ops(flop=4)) if record_time else ()))
    crossings = tuple(
        _add(_trig(True, bool(k) or record_time, bool(k)), _AZIMUTH[k],
             *((_TDOT, _ops(flop=4)) if record_time else ()))
        for k in kinds)
    return (Work(step["flop"] + step["div"], step, dtype),
            tuple(Work(c["flop"] + c["div"], c, dtype) for c in crossings))


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
