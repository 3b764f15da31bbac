"""The kernels' bounds (light_path_tracer_tpu_torch/ops/cuda/bounds.py) and
what ties the extras kernel's Python side to its sources, on the CPU.

The operation counts are read from the CUDA sources by hand; these tests
pin them, form by form and width by width, so that a change to a
functor's arithmetic shows here and is counted anew. The counted bound
must never fall below the flops-only one (a flop there is half an FMA at
the published peak; here one instruction, at the published instruction
rate unless the probe reads higher), and both scale linearly in the
attempts. The extras instances the wrappers list
(chip_smoke.py labels ptxas's report with them) must be the ones the
sources instantiate, and every functor must state its block bound. The peak
probe's library-sequence chains run their plain version on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from light_path_tracer_tpu_torch.ops import tableau as tb
from light_path_tracer_tpu_torch.ops.cuda import _build, bounds, peak_probe
from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk

CSRC = Path(__file__).resolve().parents[1] / "light_path_tracer_tpu_torch" \
    / "csrc"

# A card's rates as peak_probe.measure_rates reports them, at the
# published FP32 / FP64 peaks for the FMA chains and a plausible
# throughput for each library form (calls a second).
RATES = {"fma32x8": dict(rate=bounds.PEAK_FP32),
         "fma64": dict(rate=bounds.PEAK_FP64)}
for _op, _r in dict(exp=2.5e12, pow=6e11, div=2e12, sqrt=3e12, sin=1.5e12,
                    cos=1.5e12).items():
    RATES[f"{_op}32x8"] = dict(rate=_r)
    RATES[f"{_op}64x8"] = dict(rate=_r / 8)


def ops(**kw):
    return {k: kw.get(k, 0) for k in bounds.KINDS}


# (kind, width, absorbing, profile, field) -> one RHS evaluation's work,
# geodesic included, as read from the sources.
RHS = {
    ("thin", 0, False, "torus", ""): ops(flop=159, div=12, sin=1, cos=1,
                                         exp=1, pow=2, sqrt=1),
    ("absorbed", 0, False, "torus", ""): ops(flop=161, div=13, sin=1,
                                             cos=1, exp=2, pow=2, sqrt=1),
    ("thin", 0, False, "jet", ""): ops(flop=146, div=14, sin=1, cos=1,
                                       exp=2, pow=2, sqrt=2),
    ("stokes", 0, False, "torus", "toroidal"): ops(
        flop=342, div=30, sin=1, cos=1, exp=1, pow=3, sqrt=4),
    ("stokes", 0, False, "torus", "vertical"): ops(
        flop=342, div=31, sin=1, cos=1, exp=1, pow=3, sqrt=4),
}
for _b in range(1, 9):
    RHS[("spectral", _b, False, "torus", "")] = ops(
        flop=161 + 3 * _b, div=12, sin=1, cos=1, exp=1 + _b, pow=3, sqrt=1)
for _f in range(1, 9):
    RHS[("movie", _f, False, "torus", "")] = ops(
        flop=181 + 9 * _f, div=14 + _f, sin=1, cos=1 + _f, exp=1 + _f,
        pow=2, sqrt=1)
    RHS[("movie", _f, True, "torus", "")] = ops(
        flop=183 + 9 * _f, div=15 + _f, sin=1, cos=1 + _f, exp=2 + _f,
        pow=2, sqrt=1)
for _o in range(2, 5):
    RHS[("order", _o, False, "torus", "")] = ops(
        flop=168, div=13, sin=1, cos=1, exp=2, pow=2, sqrt=1)
    RHS[("order", _o, True, "torus", "")] = ops(
        flop=170, div=14, sin=1, cos=1, exp=3, pow=2, sqrt=1)


@pytest.mark.parametrize("key", list(RHS), ids=lambda k: "-".join(
    str(x) for x in k if x != ""))
def test_rhs_operation_counts_of_every_form_and_width(key):
    kind, width, absorbing, profile, field = key
    got = bounds.rhs_ops(kind, width, absorbing, profile,
                         field or "toroidal")
    assert got == RHS[key]
    work = bounds.extras_work(kind, width, absorbing, profile,
                              field or "toroidal")
    n = bounds.components(kind, width, absorbing)
    # six evaluations; per component 64 flops and a division; the norm,
    # the controller and lambda
    want = {k: 6 * RHS[key][k] for k in bounds.KINDS}
    want["flop"] += 64 * n + 7
    want["div"] += n + 1
    want["sqrt"] += 1
    want["pow"] += 1
    assert work.ops == want
    assert work.flops == bounds.attempt_flops(
        n, bounds.form_flops(kind, width, absorbing))


def test_components_of_every_form():
    assert [bounds.components("spectral", b) for b in (1, 8)] == [7, 14]
    assert bounds.components("movie", 8, True) == 15
    assert bounds.components("order", 3, False) == 9
    assert bounds.components("stokes") == 8


def test_kerr_and_orbit_work():
    k32, k64 = bounds.kerr_work(), bounds.kerr_work("float64")
    assert k32.ops == ops(flop=6 * 117 + 5 * 64 + 7, div=6 * 3 + 5 + 1,
                          sqrt=1, pow=1, sin=6, cos=6)
    assert k64.ops["flop"] == k32.ops["flop"] - 2 * 5
    assert k32.flops == bounds.attempt_flops(5) == 6 * 148 + 86 * 5 + 55
    assert bounds.orbit_work().ops == ops(flop=45, div=1)
    assert bounds.orbit_work(charged=True).ops == ops(flop=57, div=1)
    assert bounds.orbit_work().flops == bounds.ORBIT_STEP_FLOPS


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kerr_work_of_each_family(dtype):
    """Kerr-Newman is Kerr's attempt with 4 more flops an evaluation;
    Johannsen-Psaltis's RHS has 170 flops and 23 divisions an evaluation,
    the attempt's other work is Kerr's."""
    k = bounds.kerr_work(dtype)
    assert bounds.kerr_work(dtype, "kerr") == k
    kn = bounds.kerr_work(dtype, "kerr_newman")
    assert kn.ops == bounds._add(k.ops, ops(flop=6 * 4))
    assert kn.flops == k.flops + 6 * 4
    jp = bounds.kerr_work(dtype, "johannsen_psaltis")
    assert jp.ops == bounds._add(k.ops, ops(flop=6 * (170 - 117),
                                            div=6 * (23 - 3)))
    assert jp.flops == k.flops + 6 * (170 + 23 - 117 - 3)
    with pytest.raises(KeyError):
        bounds.kerr_work(dtype, "custom")


@pytest.mark.parametrize("kinds,record_time,step,crossing", [
    # the equatorial plane: a cosine of theta and the detector's
    # subtraction and sign product; its crossing's sine for the azimuth
    ((0,), False, ops(flop=2, cos=1), [ops(flop=1, sin=1)]),
    # with the time recorder: sin theta more, one tdot and the trapezoid
    ((0,), True, ops(flop=24, div=2, sin=1, cos=1),
     [ops(flop=23, div=2, sin=1, cos=1)]),
    # a warp and a tilted plane with the time recorder: one set of sines
    # and cosines a state (2 + 2), the warp's basis (a pow, a sin, a cos,
    # two divisions) and one tdot, 11 library calls an accepted attempt
    ((2, 1), True, ops(flop=10 + 1 + 7 + 1 + 18 + 4, div=4, pow=1, sin=3,
                       cos=3),
     [ops(flop=30 + 22, div=5, pow=1, sin=3, cos=3, atan2=1),
      ops(flop=25 + 22, div=3, sin=2, cos=2, atan2=1)]),
    ((1, 0), False, ops(flop=7 + 1 + 1 + 1, sin=2, cos=2),
     [ops(flop=25, div=1, sin=2, cos=2, atan2=1), ops(flop=1, sin=1)]),
], ids=["equatorial", "equatorial-time", "warp-tilt-time", "tilt-equatorial"])
def test_planes_work_counts_each_state_once(kinds, record_time, step,
                                            crossing):
    """The plane recorder's work an accepted attempt counts each plane's
    detector and tdot at the step's end only (the start's are carried)
    and one set of sines and cosines a state; a crossing is counted on
    its own plane."""
    s, c = bounds.planes_work(kinds, record_time=record_time)
    assert s.ops == step
    assert s.flops == step["flop"] + step["div"]
    assert [w.ops for w in c] == crossing
    assert all(w.dtype == "float32" for w in (s, *c))


def test_geometry_mode_drops_the_redshift():
    full = bounds.rhs_ops("spectral", 2)
    geo = bounds.rhs_ops("spectral", 2, geometry=True)
    assert full["pow"] - geo["pow"] == 3 and full["sqrt"] - geo["sqrt"] == 1
    assert bounds.rhs_ops("thin", profile="shell", geometry=True) == \
        bounds._add(bounds.GEODESIC, ops(flop=5, div=4, exp=2))


def test_dop853_sums_derive_from_the_tableau():
    """One DOP853 attempt's sums a component, counted from the tableau's
    nonzeros: 50 stage weights in 11 rows, each row a left fold times h
    plus y (2 m + 1 flops for m weights), and 8 weights each in the
    solution and the two estimators (2 m - 1 each, the first weight a
    product alone), then y + h times the solution (2)."""
    rows = [len(r) for r in tb.D853_A]
    assert rows[0] == 0 and sum(rows) == 50 and len(rows) == 12
    assert [len(w) for w in (tb.D853_B, tb.D853_E5, tb.D853_E3)] == [8] * 3
    assert bounds.dop853_sum_flops() == (2 * 50 + 11) + 3 * (2 * 8 - 1) + 2
    assert bounds.dop853_sum_flops() == 158
    assert bounds.rhs_evaluations("dop853") == 12
    assert bounds.rhs_evaluations("dp45") == 6
    # Every row reads only earlier stages, and the three sums read
    # stages 0 and 5..11: each can run as its stages are made (the
    # kernel's live-stage plan).
    for r, row in enumerate(tb.D853_A):
        assert all(j < r for j, _ in row)
    for w in (tb.D853_B, tb.D853_E5, tb.D853_E3):
        assert [j for j, _ in w] == [0, 5, 6, 7, 8, 9, 10, 11]
    last = {}
    for r, row in enumerate(tb.D853_A):
        for j, _ in row:
            last[j] = r
    assert last[1] == 2 and last[2] == 4
    assert all(last[j] == 11 for j in (0, 3, 4, 5, 6, 7, 8, 9, 10))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("family", ["kerr", "kerr_newman",
                                    "johannsen_psaltis"])
def test_kerr_work_dop853(dtype, family):
    """Twelve evaluations of the family's RHS; per component the sums,
    the error scale (4 flops in float32, 2 in float64), two ratios (two
    divisions) and two squares' sums (4); then the combined norm (4
    flops, a division, a sqrt) and DP45's controller and lambda update
    (7 flops and the pow)."""
    geo = bounds.GEODESIC_FAMILIES[family]
    scale = 4 if dtype == "float32" else 2
    want = bounds._add(bounds._times(12, geo),
                       ops(flop=5 * (158 + scale + 4) + 11, div=5 * 2 + 1,
                           sqrt=1, pow=1))
    work = bounds.kerr_work(dtype, family, method="dop853")
    assert work.ops == want and work.dtype == dtype
    dp45 = bounds.kerr_work(dtype, family)
    extra = (geo["flop"] + geo["div"]) - (bounds.GEODESIC["flop"]
                                          + bounds.GEODESIC["div"])
    assert dp45.flops == 6 * (bounds.RHS5_FLOPS + extra) + 86 * 5 + 55
    assert work.flops == (12 * (bounds.RHS5_FLOPS + extra)
                          + (86 - 46 + 158 + 3) * 5 + 59)


@pytest.mark.parametrize("key", [k for k in RHS if k[1] in (0, 2, 8)],
                         ids=lambda k: "-".join(str(x) for x in k
                                                if x != ""))
def test_extras_work_dop853_of_each_form(key):
    kind, width, absorbing, profile, field = key
    n = bounds.components(kind, width, absorbing)
    for dtype, scale in (("float32", 4), ("float64", 2)):
        work = bounds.extras_work(kind, width, absorbing, profile,
                                  field or "toroidal", dtype, "dop853")
        want = {k: 12 * RHS[key][k] for k in bounds.KINDS}
        want["flop"] += (158 + scale + 4) * n + 11
        want["div"] += 2 * n + 1
        want["sqrt"] += 1
        want["pow"] += 1
        assert work.ops == want
        assert work.flops == bounds.attempt_flops(
            n, bounds.form_flops(kind, width, absorbing), "dop853")


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("family", ["kerr", "kerr_newman"])
def test_kerr_work_mu_chart(family, dtype, method):
    """The mu chart's attempt is the theta chart's with rhs5_mu for
    rhs5_trig: 118 flops and three reciprocals an evaluation for Kerr
    (Kerr-Newman 4 more), no sin and no cos; the rest of the attempt is
    the pair's. Johannsen-Psaltis has no mu chart."""
    k = 6 if method == "dp45" else 12
    theta = bounds.kerr_work(dtype, family, method)
    mu = bounds.kerr_work(dtype, family, method, chart="mu")
    geo = bounds.MU_GEODESIC_FAMILIES[family]
    assert geo == ops(flop=118 + (4 if family == "kerr_newman" else 0),
                      div=3)
    want = bounds._add(theta.ops, bounds._times(k, geo),
                       bounds._times(-k, bounds.GEODESIC_FAMILIES[family]))
    assert mu.ops == want
    assert mu.ops["sin"] == mu.ops["cos"] == 0
    theta_geo = bounds.GEODESIC_FAMILIES[family]
    assert mu.flops == theta.flops + k * (geo["flop"] - theta_geo["flop"])
    assert bounds.counted_bound_ms(1000 * mu, 0, RATES)[0] < \
        bounds.counted_bound_ms(1000 * theta, 0, RATES)[0]
    with pytest.raises(KeyError):
        bounds.kerr_work(dtype, "johannsen_psaltis", method, chart="mu")


def test_work_of_two_launches_adds():
    """A driver's two passes: the work adds kind by kind in one scalar
    type, and work of two types does not add."""
    a, b = bounds.kerr_work(chart="mu"), bounds.kerr_work()
    both = 3 * a + 2 * b
    assert both.flops == 3 * a.flops + 2 * b.flops
    assert both.ops == bounds._add(bounds._times(3, a.ops),
                                   bounds._times(2, b.ops))
    with pytest.raises(ValueError):
        a + bounds.kerr_work("float64")


# The Kerr-Newman flow against Kerr's in one RHS evaluation: the
# geodesic's 4 flops, W and Delta's 2, and the circular flow's charged
# Keplerian Omega (4 flops and a sqrt more, no pow); the jet has no
# Keplerian Omega; the movie's tdot adds 2.
KN_EXTRA = {
    ("thin", 0, False, "torus"): ops(flop=4 + 2 + 4, sqrt=1, pow=-1),
    ("absorbed", 0, False, "torus"): ops(flop=4 + 2 + 4, sqrt=1, pow=-1),
    ("thin", 0, False, "jet"): ops(flop=4 + 2),
    ("spectral", 3, False, "torus"): ops(flop=4 + 2 + 4, sqrt=1, pow=-1),
    ("movie", 8, True, "torus"): ops(flop=4 + 2 + 4 + 2, sqrt=1, pow=-1),
    ("order", 2, False, "torus"): ops(flop=4 + 2 + 4, sqrt=1, pow=-1),
}


@pytest.mark.parametrize("key", list(KN_EXTRA), ids=lambda k: "-".join(
    str(x) for x in k))
def test_extras_work_kerr_newman(key):
    kind, width, absorbing, profile = key
    kerr = bounds.rhs_ops(kind, width, absorbing, profile)
    kn = bounds.rhs_ops(kind, width, absorbing, profile,
                        family="kerr_newman")
    assert kn == bounds._add(kerr, KN_EXTRA[key])
    for method, k in (("dp45", 6), ("dop853", 12)):
        wk = bounds.extras_work(kind, width, absorbing, profile,
                                method=method)
        wn = bounds.extras_work(kind, width, absorbing, profile,
                                method=method, family="kerr_newman")
        assert wn.ops == bounds._add(wk.ops, bounds._times(k, KN_EXTRA[key]))
        extra = KN_EXTRA[key]["flop"] + KN_EXTRA[key]["div"]
        assert wn.flops == wk.flops + k * extra


WORKS = [("kerr", bounds.kerr_work()), ("kerr f64",
                                        bounds.kerr_work("float64")),
         ("kerr_newman", bounds.kerr_work(family="kerr_newman")),
         ("johannsen_psaltis f64",
          bounds.kerr_work("float64", "johannsen_psaltis")),
         ("orbit", bounds.orbit_work()),
         ("orbit f64", bounds.orbit_work(True, "float64")),
         ("kerr dop853", bounds.kerr_work(method="dop853")),
         ("johannsen_psaltis dop853 f64",
          bounds.kerr_work("float64", "johannsen_psaltis", "dop853")),
         ("kerr mu", bounds.kerr_work(chart="mu")),
         ("kerr_newman mu dop853 f64",
          bounds.kerr_work("float64", "kerr_newman", "dop853", "mu")),
         ("thin kerr_newman", bounds.extras_work("thin",
                                                 family="kerr_newman")),
         ("movie kerr_newman dop853 f64", bounds.extras_work(
             "movie", 8, True, dtype="float64", method="dop853",
             family="kerr_newman"))]
WORKS += [(f"{k} {w} {ab} {dt}", bounds.extras_work(k, w, ab, dtype=dt))
          for k, w, ab in (("thin", 0, False), ("absorbed", 0, False),
                           ("spectral", 8, False), ("stokes", 0, False),
                           ("movie", 8, True), ("order", 4, True))
          for dt in ("float32", "float64")]
WORKS += [(f"{k} dop853 {dt}", bounds.extras_work(k, w, ab, dtype=dt,
                                                  method="dop853"))
          for k, w, ab in (("thin", 0, False), ("movie", 8, True))
          for dt in ("float32", "float64")]


@pytest.mark.parametrize("name,work", WORKS, ids=[w[0] for w in WORKS])
def test_counted_bound_is_above_the_flops_only_bound(name, work):
    attempts = 3_000_000
    total = attempts * work
    flops_ms, by = bounds.flops_bound_ms(total, 12 * attempts // 30)
    counted_ms, cby, parts = bounds.counted_bound_ms(
        total, 12 * attempts // 30, RATES)
    assert by == cby == "operations"
    assert counted_ms >= flops_ms > 0
    assert counted_ms == pytest.approx(sum(parts.values()))
    assert set(parts) <= set(bounds.KINDS)


@pytest.mark.parametrize("name,work", WORKS[:6], ids=[w[0] for w in
                                                      WORKS[:6]])
def test_bounds_scale_linearly_in_the_attempts(name, work):
    one = bounds.counted_bound_ms(1_000_000 * work, 0, RATES)[0]
    two = bounds.counted_bound_ms(2_000_000 * work, 0, RATES)[0]
    assert two == pytest.approx(2.0 * one, rel=1e-12)
    f1 = bounds.flops_bound_ms(1_000_000 * work, 0)[0]
    f2 = bounds.flops_bound_ms(2_000_000 * work, 0)[0]
    assert f2 == pytest.approx(2.0 * f1, rel=1e-12)


@pytest.mark.parametrize("dtype,form", [("float32", "fma32x8"),
                                        ("float64", "fma64")])
@pytest.mark.parametrize("scale", [0.5, 0.91, 1.0, 1.2])
def test_a_flop_is_priced_at_no_less_than_the_published_rate(dtype, form,
                                                             scale):
    peak = bounds.PEAK_FP64 if dtype == "float64" else bounds.PEAK_FP32
    rates = dict(RATES, **{form: dict(rate=scale * peak)})
    work = bounds.Work(0, ops(flop=10**12), dtype)
    ms = bounds.counted_bound_ms(work, 0, rates)[2]["flop"]
    assert ms == pytest.approx(1e3 * 10**12 / (max(scale, 1.0) * peak / 2),
                               rel=1e-12)
    assert ms <= 1e3 * 10**12 / bounds.PUBLISHED_FLOP[dtype]


def test_bytes_bind_a_launch_that_does_little_work():
    work = 10 * bounds.orbit_work()
    ms, by, _parts = bounds.counted_bound_ms(work, 10**9, RATES)
    assert by == "bytes" and ms == pytest.approx(1e3 * 1e9 / 3.35e12)


def test_every_rate_form_is_a_probe_form():
    for dtype, kinds in bounds.RATE_FORMS.items():
        assert set(kinds) == set(bounds.KINDS)
        for form, per in kinds.values():
            assert form in peak_probe.FORMS and per > 0
            want = torch.float64 if dtype == "float64" else torch.float32
            assert peak_probe.FORMS[form][1] == want


def _tags():
    """The functors each family source instantiates, as
    volumetric_kernel.extras_instances labels them (float)."""
    names = set()
    for f in CSRC.glob("kerr_dp45_*.cu*"):
        text = f.read_text()
        for args in re.findall(r"Tag<(\w+<[^>]*>)>", text):
            names.add(args)
    labels = set()
    for name in names:
        m = re.match(r"(\w+)<(.*)>", name)
        fun, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
        if args[-1] != "Real":
            continue
        if fun == "Movie" and args[0] == "kFrames":
            continue
        labels.add((fun, tuple(args[:-1])))
    return labels


def test_instances_listed_are_the_instances_built():
    listed = vk.extras_instances()
    assert len({x[0] for x in listed}) == len(listed)
    floats = [x for x in listed if x[4] == torch.float32]
    assert len(floats) == len(listed) // 2 == 2 + 8 + 1 + 16 + 6
    tags = _tags()
    for label, entry, form, variant, _dtype in floats:
        m = re.match(r"kerr_dp45_extras<(\w+)<(.*)>>$", label)
        fun, args = m.group(1), m.group(2).split(",")[:-1]
        if fun == "Movie":
            # the movie sources instantiate Movie<n, kAbsorbing, Real>
            assert ("Movie", (args[0], "kAbsorbing")) in tags
            assert entry.endswith("absorbed" if form else "thin")
            continue
        vals = tuple(a.split("=")[-1] for a in args)
        if fun == "Order":
            vals = (vals[0], "true" if vals[1] == "1" else "false")
        assert (fun, vals) in tags, (label, sorted(tags))
    assert {e for _l, e, *_r in listed} == set(_build.EXTRAS_ENTRIES)


def test_kerr_newman_instances_are_the_kerr_ones_but_stokes():
    """Each *_kn source builds its Kerr sibling with LPT_KN and the _kn
    infix (its _f64 and DOP853 twins include it), so the Kerr-Newman
    instances are the Kerr functors but Stokes, under the entries with
    "_kn", labelled kerr_dp45_extras_kn."""
    kerr = [x for x in vk.extras_instances() if "Stokes" not in x[0]]
    for method, kernel in (("dp45", "kerr_dp45_extras"),
                           ("dop853", "kerr_dop853_extras")):
        kn = vk.extras_instances(method, "_kn")
        assert [x[2:] for x in kn] == [x[2:] for x in kerr]
        assert [x[1] for x in kn] == [x[1] + "_kn" for x in kerr]
        assert [x[0] for x in kn] == [
            x[0].replace("kerr_dp45_extras", kernel + "_kn") for x in kerr]
    for entry in _build.KN_EXTRAS_ENTRIES:
        name = entry[len("lpt_"):]
        text = (CSRC / f"{name}_kn.cu").read_text()
        assert "#define LPT_KN 1" in text and "#define LPT_INFIX _kn" in text
        assert f'#include "{name}.cu"' in text
        assert f'#include "{name}_kn.cu"' in (CSRC / f"{name}_kn_f64.cu"
                                               ).read_text()
        stem = name.replace("kerr_dp45", "kerr_dop853")
        assert f'#include "{name}_kn.cu"' in (CSRC / f"{stem}_kn.cu"
                                               ).read_text()
        assert f'#include "{stem}_kn.cu"' in (CSRC / f"{stem}_kn_f64.cu"
                                               ).read_text()
    assert not (CSRC / "kerr_dp45_stokes_kn.cu").exists()


def test_mu_sources_build_the_mu_chart():
    text = (CSRC / "kerr_dp45_mu.cu").read_text()
    assert "#define LPT_MU 1" in text and "#define LPT_INFIX _mu" in text
    assert '#include "kerr_dp45.cu"' in text
    for name, inc in (("kerr_dp45_mu_f64", "kerr_dp45_mu"),
                      ("kerr_dop853_mu", "kerr_dp45_mu"),
                      ("kerr_dop853_mu_f64", "kerr_dop853_mu")):
        assert f'#include "{inc}.cu"' in (CSRC / f"{name}.cu").read_text()
    assert _build.KERR_ENTRIES == ("lpt_kerr_dp45", "lpt_kerr_dp45_mu",
                                   "lpt_kerr_dp45_wide")
    assert {"kerr_dop853_mu.cu", "kerr_dop853_mu_f64.cu"} <= {
        s.name for s in _build._sources("dop853")}


def test_three_libraries_split_the_sources():
    """The DP45 mu-chart, wide-disk and Kerr-Newman-extras sources form
    the "more" library (built apart, so the first DP45 launch builds no
    instance of either), every DOP853 source the "dop853" one, the rest
    "dp45"; each source belongs to exactly one, but for the float64 pow
    that every library compiles beside its float64 extras sources."""
    libs = {name: {s.name for s in _build._sources(name)}
            for name in _build.LIBRARIES}
    every = {s.name for s in CSRC.glob("*.cu")} - {_build.POW_SOURCE}
    assert set().union(*libs.values()) == every
    assert sum(len(v) for v in libs.values()) == len(every)
    assert libs["more"] == {
        "kerr_dp45_mu.cu", "kerr_dp45_mu_f64.cu", "kerr_dp45_wide.cu",
        "kerr_dp45_wide_f64.cu", "kerr_dp45_planes.cu",
        "kerr_dp45_planes_f64.cu"} | {
        f"{e[len('lpt_'):]}_kn{d}.cu" for e in _build.KN_EXTRAS_ENTRIES
        for d in ("", "_f64")}
    assert {"kerr_dop853_wide.cu", "kerr_dop853_wide_f64.cu",
            "kerr_dop853_planes.cu", "kerr_dop853_planes_f64.cu"} <= libs[
        "dop853"]
    assert "kerr_dp45.cu" in libs["dp45"] and all(
        n.startswith("kerr_dop853") for n in libs["dop853"])
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        library_of)
    assert [library_of(m, v) for m in ("dp45", "dop853")
            for v in (False, True)] == ["dp45", "more", "dop853", "dop853"]
    assert _build.library_path("more").name.startswith("lpt_more_")


def test_dop853_instances_are_the_dp45_ones_with_the_other_pair():
    """Each DOP853 source builds its DP45 sibling with LPT_DOP853 (the
    _f64 twin includes the float one), so the DOP853 library holds the
    same functors, labelled kerr_dop853_extras, under the same entries
    with "_dop853" before the dtype's suffix."""
    dp45 = vk.extras_instances()
    dop = vk.extras_instances("dop853")
    assert [x[1:] for x in dop] == [x[1:] for x in dp45]
    assert [x[0] for x in dop] == [
        x[0].replace("kerr_dp45_extras", "kerr_dop853_extras") for x in dp45]
    for name in ["kerr_dp45"] + [e[len("lpt_"):] for e in
                                 _build.EXTRAS_ENTRIES]:
        stem = name.replace("kerr_dp45", "kerr_dop853")
        text = (CSRC / f"{stem}.cu").read_text()
        assert "#define LPT_DOP853 1" in text
        assert f'#include "{name}.cu"' in text
        f64 = (CSRC / f"{stem}_f64.cu").read_text()
        assert "#define LPT_DOUBLE 1" in f64
        assert f'#include "{stem}.cu"' in f64
    srcs = {s.name for s in _build._sources("dop853")}
    assert srcs == {s.name for s in CSRC.glob("kerr_dop853*.cu")
                    if "_broad" not in s.name}
    assert not srcs & {s.name for s in _build._sources("dp45")}
    assert _build.library_path("dop853").name.startswith("lpt_dop853_")
    assert _build.library_path("dp45").name.startswith("lpt_kernels_")


@pytest.mark.parametrize("source", ["kerr_dp45_extras.cu",
                                    "kerr_dp45_stokes.cu",
                                    "kerr_dp45_movie.cuh",
                                    "kerr_dp45_orders.cu"])
def test_every_functor_states_its_block_bound(source):
    text = (CSRC / source).read_text()
    functors = re.findall(r"\nstruct (\w+) \{\n  static constexpr int "
                          r"kExtras", text)
    assert functors
    for name in functors:
        body = text.split(f"struct {name} {{", 1)[1].split("\n};", 1)[0]
        assert re.search(r"static constexpr int kMinBlocks =\s", body), name
    assert "_describe)(int form, int variant" in "".join(
        (CSRC / f).read_text() for f in (
            "kerr_dp45_extras.cu", "kerr_dp45_stokes.cu",
            "kerr_dp45_movie_thin.cu", "kerr_dp45_movie_absorbed.cu",
            "kerr_dp45_orders.cu"))


def test_block_bound_line_the_study_rewrites():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_kernel_study.py"
    spec = importlib.util.spec_from_file_location("torch_kernel_study", path)
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    text = (CSRC / "kerr_dp45_extras.cuh").read_text()
    assert text.count(study.BOUND_EXPR) == 2
    assert f"__launch_bounds__(kThreads, {study.BOUND_EXPR})" in text
    assert f"out[3] = {study.BOUND_EXPR};" in text


@pytest.mark.parametrize("form", sorted(f for f in peak_probe.FORMS
                                        if f.endswith("x8")
                                        and f != "fma32x8"))
def test_library_chains_on_the_cpu_follow_their_recurrence(form):
    dtype = peak_probe.FORMS[form][1]
    x = torch.linspace(0.1, 0.9, 33, dtype=dtype)
    k = 16
    got = peak_probe.chain_cuda(x, k, form)
    step, b = peak_probe.LIBRARY_FORMS[form[:-4]]
    npdt = np.float64 if dtype == torch.float64 else np.float32
    fn = dict(exp=lambda v: np.exp(-v), pow=lambda v: npdt(b) ** v,
              div=lambda v: npdt(b) / v, sqrt=np.sqrt, sin=np.sin,
              cos=np.cos, atan2=lambda v: np.arctan2(v, npdt(b)))[form[:-4]]
    vs = [x.numpy() + npdt(0.01) * npdt(j) for j in range(8)]
    for _ in range(k):
        vs = [fn(v).astype(npdt) for v in vs]
    want = sum(vs[1:], vs[0])
    ulp = np.finfo(npdt).eps
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * k * ulp * np.abs(want).max())
    short, long_ = peak_probe.CHAIN_LENGTHS[form]
    assert 0 < short < long_


def test_probe_forms_have_distinct_indices():
    idx = [v[0] for v in peak_probe.FORMS.values()]
    assert sorted(idx) == list(range(len(idx)))


def test_float64_extras_sources_link_the_contracted_pow(monkeypatch,
                                                        tmp_path):
    """Each library compiles its float64 extras, plane-recorder, broad
    and surface sources (and only those) as relocatable device code
    calling lpt_pow_f64, compiles csrc/lpt_pow_f64.cu with contraction,
    device-links the relocatable objects and links the device-link
    object into the library; every other source keeps -fmad=false and no
    -rdc."""
    f64_extras = {n for n in (s.name for s in CSRC.glob("*.cu"))
                  if n.endswith("_f64.cu") and any(
                      f in n for f in ("_extras", "_stokes", "_movie",
                                       "_orders", "_planes", "_broad",
                                       "kerr_surface"))}
    assert {n for n in (s.name for s in CSRC.glob("*.cu"))
            if _build._rdc_source(n)} == f64_extras
    pow_src = (CSRC / _build.POW_SOURCE).read_text()
    assert "__noinline__ double lpt_pow_f64" in pow_src
    common = (CSRC / "kerr_dp45_common.cuh").read_text()
    assert "#ifdef LPT_EXTERN_POW_F64" in common
    assert "-fmad=false" not in _build.POW_FLAGS
    assert "-fmad=true" in _build.POW_FLAGS
    for library in _build.LIBRARIES:
        cmds = []
        monkeypatch.setattr(_build, "_start", lambda cmd: (cmd, None))
        monkeypatch.setattr(_build, "_run",
                            lambda procs: cmds.extend(c for c, _ in procs)
                            or "")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build.os, "replace", lambda a, b: None)
        monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
        _build._compile(tmp_path / f"{library}.so", library)
        compiles = {c[-1].rsplit("/", 1)[-1]: c for c in cmds if "-c" in c}
        rdc = {n for n, c in compiles.items() if "-rdc=true" in c}
        assert rdc - {_build.POW_SOURCE} == {
            s.name for s in _build._sources(library)} & f64_extras
        assert _build.POW_SOURCE in rdc
        for name, cmd in compiles.items():
            if name == _build.POW_SOURCE:
                assert "-fmad=false" not in cmd
            else:
                assert "-fmad=false" in cmd
                assert ("-DLPT_EXTERN_POW_F64=1" in cmd) == (name in rdc)
        dlink = [c for c in cmds if "-dlink" in c]
        assert len(dlink) == 1 and len(
            [a for a in dlink[0] if a.endswith(".o")]) == len(rdc) + 1
        link = [c for c in cmds if "-shared" in c]
        assert len(link) == 1 and any(a.endswith("dlink.o")
                                      for a in link[0])


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind, absorbing", [
    ("spectral", False), ("movie", False), ("movie", True),
    ("order", False), ("order", True)])
def test_broad_work_drops_the_wide_stage_arguments(kind, absorbing, dtype,
                                                   method):
    """A broad instance's attempt is a narrow one's of the same width
    less, a wide component, its stage arguments' sums (DP45's five rows,
    35 flops; DOP853's eleven) and (DP45) its stage-2 slope; at width 0
    it is the narrow form's core. Its memory-held state moves four
    scalars a component an attempt."""
    width = 12
    narrow = bounds.extras_work(kind, width, absorbing, dtype=dtype,
                                method=method)
    broad = bounds.broad_work(kind, width, absorbing, dtype=dtype,
                              method=method)
    rows = (35 if method == "dp45"
            else sum(2 * len(r) + 1 for r in tb.D853_A[1:]))
    slope = bounds._width_slope_ops(kind, absorbing)
    want = {k: narrow.ops[k] - width * ((rows if k == "flop" else 0)
                                        + (slope[k] if method == "dp45"
                                           else 0))
            for k in bounds.KINDS}
    assert broad.ops == want
    assert broad.flops == broad.ops["flop"] + broad.ops["div"]
    core = bounds.broad_work(kind, 0, absorbing, dtype=dtype, method=method)
    assert core.ops == bounds.extras_work(kind, 0, absorbing, dtype=dtype,
                                          method=method).ops
    assert bounds.broad_state_bytes(width, dtype) == 4 * width * (
        8 if dtype == "float64" else 4)


def test_broad_instances_are_the_broad_sources():
    """The broad library holds every *_broad* source and nothing else;
    its extras instances are five forms a pair, family and dtype, labelled
    kerr_dp45_broad / kerr_dop853_broad, each functor with its block
    bound; its DOP853, float64 and Kerr-Newman sources include their
    siblings as the narrow ones do."""
    libs = {name: {s.name for s in _build._sources(name)}
            for name in _build.LIBRARIES}
    assert libs["broad"] == {s.name for s in CSRC.glob("*_broad*.cu")}
    assert len(libs["broad"]) == 12
    for method in ("dp45", "dop853"):
        for family in ("", "_kn"):
            rows = vk.broad_instances(method, family)
            assert len(rows) == 10 and {r[1] for r in rows} == {
                vk.BROAD_ENTRY + family}
            assert [r[2] for r in rows] == list(range(5)) * 2
            assert all(r[0].startswith(("kerr_dop853_broad" if method ==
                                        "dop853" else "kerr_dp45_broad")
                                       + family + "<") for r in rows)
    text = (CSRC / "kerr_broad_extras.cuh").read_text()
    functors = re.findall(r"\nstruct (Broad\w+) \{\n  static constexpr int "
                          r"kLead", text)
    assert sorted(functors) == ["BroadMovie", "BroadOrder", "BroadSpectral"]
    for name in functors:
        body = text.split(f"struct {name} {{", 1)[1].split("\n};", 1)[0]
        assert re.search(r"static constexpr int kMinBlocks =\s", body), name
    for stem, inc in (("kerr_dp45_broad_f64", "kerr_dp45_broad"),
                      ("kerr_dp45_broad_kn", "kerr_dp45_broad"),
                      ("kerr_dp45_broad_kn_f64", "kerr_dp45_broad_kn"),
                      ("kerr_dop853_broad", "kerr_dp45_broad"),
                      ("kerr_dop853_broad_f64", "kerr_dop853_broad"),
                      ("kerr_dop853_broad_kn", "kerr_dp45_broad_kn"),
                      ("kerr_dop853_broad_kn_f64", "kerr_dop853_broad_kn"),
                      ("kerr_dp45_broad_planes_f64",
                       "kerr_dp45_broad_planes"),
                      ("kerr_dop853_broad_planes", "kerr_dp45_broad_planes"),
                      ("kerr_dop853_broad_planes_f64",
                       "kerr_dop853_broad_planes")):
        assert f'#include "{inc}.cu"' in (CSRC / f"{stem}.cu").read_text()
    planes = (CSRC / "kerr_dp45_broad_planes.cu").read_text()
    assert "#define LPT_BROAD_PLANES 1" in planes
    assert _build.library_path("broad").name.startswith("lpt_broad_")


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("family", ["kerr", "kerr_newman",
                                    "johannsen_psaltis"])
def test_surface_work_is_the_kerr_attempt_plus_the_time(family, method):
    """The surface kernel's attempt (csrc/kerr_surface.cuh): without the
    time component the Kerr kernel's over 5 components; with it 6
    components and the time's rate in every evaluation."""
    for dtype in ("float32", "float64"):
        plain = bounds.surface_work(dtype, family, method, False)
        assert plain == bounds.kerr_work(dtype, family, method)
        timed = bounds.surface_work(dtype, family, method, True)
        evals = bounds.rhs_evaluations(method)
        tdot = bounds._SURFACE_TDOT[family]
        one_more = bounds.attempt_ops(6, bounds.GEODESIC_FAMILIES[family],
                                      dtype, method)
        assert timed.ops == {k: one_more[k] + evals * tdot.get(k, 0)
                             for k in bounds.KINDS}
        assert timed.flops > plain.flops and timed.dtype == dtype
