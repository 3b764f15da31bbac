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


def test_geometry_mode_drops_the_redshift():
    full = bounds.rhs_ops("spectral", 2)
    geo = bounds.rhs_ops("spectral", 2, geometry=True)
    assert full["pow"] - geo["pow"] == 3 and full["sqrt"] - geo["sqrt"] == 1
    assert bounds.rhs_ops("thin", profile="shell", geometry=True) == \
        bounds._add(bounds.GEODESIC, ops(flop=5, div=4, exp=2))


WORKS = [("kerr", bounds.kerr_work()), ("kerr f64",
                                        bounds.kerr_work("float64")),
         ("orbit", bounds.orbit_work()),
         ("orbit f64", bounds.orbit_work(True, "float64"))]
WORKS += [(f"{k} {w} {ab} {dt}", bounds.extras_work(k, w, ab, dtype=dt))
          for k, w, ab in (("thin", 0, False), ("absorbed", 0, False),
                           ("spectral", 8, False), ("stokes", 0, False),
                           ("movie", 8, True), ("order", 4, True))
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
              cos=np.cos)[form[:-4]]
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
