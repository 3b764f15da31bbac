"""Arithmetic peak-rate probe of the card (csrc/peak_probe.cu): the rates
the ray kernels' bounds are stated against.

The counterpart of `scripts/roofline.py::_chain` of the JAX package: chains
of length k over an array of elements, in these forms,

    "fma32": v <- fma(v, a, b) in float32   (2 k flops an element; the
             kernel writes each FMA explicitly, since the package builds
             with -fmad=false)
    "fma32x8": eight such chains an element, started 0.01 apart, their
             sum stored                      (16 k flops)
    "fma64": the same in float64            (2 k flops)
    "mix":   2 FMA + 3 add + 3 mul independent float32 chains, their sum
             stored                          (10 k flops)
    "sin":   v <- sin(v) in float32         (k sines)
    "exp32x8", "pow32x8", "div32x8", "sqrt32x8", "sin32x8", "cos32x8"
    and the same with 64: eight chains an element, started 0.01 apart, of
             v <- exp(-v), 0.5^v, 0.7 / v, sqrt(v), sin(v) or cos(v) in
             float32 or float64, their sum stored (8 k calls): the library
             sequences (and the IEEE division) the ray kernels run, each at
             its throughput, which ops/cuda/bounds.py counts them against

`chain_cuda` launches the hand-written kernel on a CUDA tensor and raises
on any other CUDA input; on a CPU tensor it runs `chain_plain`, the same
recurrence as a loop of tensor operations. `measure_rates` times two
chain lengths with CUDA events and returns the marginal rates, so the
launch and the element's one read and write cancel.
"""

from __future__ import annotations

import torch

from light_path_tracer_tpu_torch.ops.cuda._build import check, load_library

__all__ = ["FORMS", "LIBRARY_FORMS", "CHAIN_LENGTHS", "N_ELEMENTS",
           "MULTIPLIER", "ADDEND", "chain_plain", "chain_cuda",
           "measure_rates"]

# form -> (C form index, dtype, counted operations per link of the chain)
FORMS = {"fma32": (0, torch.float32, 2), "fma64": (1, torch.float64, 2),
         "mix": (2, torch.float32, 10), "sin": (3, torch.float32, 1),
         "fma32x8": (4, torch.float32, 16)}
# The library-sequence chains: form -> (the step as torch computes it, b).
# v <- step(v, b), eight chains an element, one call a chain and link.
LIBRARY_FORMS = {
    "exp": (lambda v, b: torch.exp(-v), 0.0),
    "pow": (lambda v, b: torch.pow(b, v), 0.5),
    "div": (lambda v, b: b / v, 0.7),
    "sqrt": (lambda v, b: torch.sqrt(v), 0.0),
    "sin": (lambda v, b: torch.sin(v), 0.0),
    "cos": (lambda v, b: torch.cos(v), 0.0)}
for _i, _op in enumerate(LIBRARY_FORMS):
    FORMS[f"{_op}32x8"] = (5 + _i, torch.float32, 8)
    FORMS[f"{_op}64x8"] = (11 + _i, torch.float64, 8)
# Chain lengths measure_rates times (short, long): the FMA forms at 2,048
# and 8,192; a library call costs tens of instructions, so its chains are
# shorter, each long launch some milliseconds on an H100.
CHAIN_LENGTHS = {form: (2048, 8192) for form in FORMS}
CHAIN_LENGTHS.update({f"{op}{bits}x8": (k // 4, k) for bits, lengths in (
    (32, dict(exp=512, pow=256, div=512, sqrt=512, sin=256, cos=256)),
    (64, dict(exp=128, pow=64, div=256, sqrt=256, sin=128, cos=128)))
    for op, k in lengths.items()})
# One thread an element: 2^22 elements are about fifteen full waves of
# threads on an H100's 132 SMs.
N_ELEMENTS = 1 << 22
MULTIPLIER = 1.0000001
ADDEND = 1e-7


def _library(form):
    """The step and its b of a library-sequence form, or None."""
    op = form[:-4]
    return LIBRARY_FORMS.get(op) if form.endswith("x8") and op else None


def chain_plain(x, k: int, form: str, a: float = MULTIPLIER,
                b: float | None = None):
    """The chain as a loop of tensor operations on x's device: the plain
    version of the kernel. It rounds the product and the sum separately
    where the kernel's FMA rounds once. b: the FMA forms' addend (default
    ADDEND), the library forms' base or numerator (default theirs)."""
    _index, dtype, _ops = FORMS[form]
    if x.dtype != dtype:
        raise ValueError(f"form {form!r} takes {dtype}, got {x.dtype}")
    lib = _library(form)
    if lib is not None:
        step, b_form = lib
        b = b_form if b is None else b
        # b as the kernel has it: a value of x's dtype
        b = float(torch.tensor(b, dtype=dtype))
        vs = [x + x.new_tensor(0.01) * j for j in range(8)]
        for _ in range(k):
            vs = [step(v, b) for v in vs]
        out = vs[0]
        for v in vs[1:]:
            out = out + v
        return out
    b = ADDEND if b is None else b
    if form == "sin":
        v = x
        for _ in range(k):
            v = torch.sin(v)
        return v
    if form in ("fma32", "fma64"):
        v = x
        for _ in range(k):
            v = v * a + b
        return v
    # a and b as the kernel has them: float32 values
    a = float(torch.tensor(a, dtype=torch.float32))
    b = float(torch.tensor(b, dtype=torch.float32))
    if form == "fma32x8":
        vs = [x + 0.01 * j for j in range(8)]
        for _ in range(k):
            vs = [v * a + b for v in vs]
        out = vs[0]
        for v in vs[1:]:
            out = out + v
        return out
    f = [x, x + 0.01]
    s = [x + 0.02, x + 0.03, x + 0.04]
    m = [x + 0.05, x + 0.06, x + 0.07]
    c = [x.new_tensor(b), x.new_tensor(2.0) * b, x.new_tensor(3.0) * b]
    d = [x.new_tensor(a), x.new_tensor(a) + 1e-8, x.new_tensor(a) + 2e-8]
    for _ in range(k):
        f = [v * a + b for v in f]
        s = [v + ci for v, ci in zip(s, c)]
        m = [v * di for v, di in zip(m, d)]
    out = f[0] + f[1]
    for v in s + m:
        out = out + v
    return out


def chain_cuda(x, k: int, form: str, a: float = MULTIPLIER,
               b: float | None = None):
    """The chain of length k over x with the CUDA kernel; returns a new
    tensor like x. x: a contiguous 1-D CUDA tensor of the form's dtype.
    Launches on the current stream and does not synchronise. A CPU tensor
    goes to chain_plain."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {tuple(FORMS)}, got "
                         f"{form!r}")
    if x.device.type == "cpu":
        return chain_plain(x, k, form, a, b)
    lib = _library(form)
    if b is None:
        b = lib[1] if lib is not None else ADDEND
    index, dtype, _ops = FORMS[form]
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"form {form!r} takes {dtype}, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D tensor")
    if not 0 <= int(k) < 2**31 or x.numel() >= 2**31:
        raise ValueError("k and the element count must fit in int32")
    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.lpt_peak_probe(
            index, x.data_ptr(), out.data_ptr(), x.numel(), int(k),
            float(a), float(b), torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "peak_probe launch")
    chain_cuda.launches += 1
    return out


# Kernel launches, so a run can show that it went through the kernel.
chain_cuda.launches = 0


def _best_ms(fn, repeats):
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def measure_rates(device="cuda", n: int = N_ELEMENTS,
                  repeats: int = 5) -> dict:
    """The card's arithmetic rates from the marginal time between each
    form's two chain lengths (CHAIN_LENGTHS), best of `repeats` launches
    each after one warm-up: {form: {"k_short", "k_long", "ms_short",
    "ms_long", "rate"}} with rate in operations per second (flops for the
    FMA and mixed forms, calls for "sin" and the library forms). Needs a
    CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("measure_rates times the CUDA kernel; it needs a "
                         "CUDA device")
    out = {}
    for form, (_index, dtype, ops) in FORMS.items():
        x = torch.full((n,), 0.5, dtype=dtype, device=device)
        k_short, k_long = CHAIN_LENGTHS[form]
        times = []
        for k in (k_short, k_long):
            chain_cuda(x, k, form)
            times.append(_best_ms(lambda: chain_cuda(x, k, form), repeats))
        marginal_s = (times[1] - times[0]) * 1e-3
        out[form] = dict(k_short=k_short, k_long=k_long, ms_short=times[0],
                         ms_long=times[1],
                         rate=ops * (k_long - k_short) * n / marginal_s)
    return out
