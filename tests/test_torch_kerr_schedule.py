"""The Kerr kernel's call layout and build flags, on the CPU.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py);
here the parts of its wrapper that plain Python reaches: the ctypes
mirror of the C call struct against the struct in csrc/kerr_dp45.cu,
field by field and in size, the build flags (no FMA contraction, no fast
math), and the CPU route of both wrappers.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from light_path_tracer_tpu_torch import disk
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops.cuda import _build
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk

R_OBS = 100.0
SOURCE = _build.CSRC / "kerr_dp45.cu"


def _c_struct_fields():
    """The member names of KerrCall<T> in declaration order."""
    text = SOURCE.read_text()
    body = re.search(r"struct KerrCall \{(.*?)\};", text, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\b(const|unsigned|char|int|long|void|T)\b", " ",
                      decl)
        names += re.findall(r"[A-Za-z_]\w*", decl)
    return names


@pytest.mark.parametrize("struct, real", [("KerrCall", "float"),
                                          ("KerrCall64", "double")])
def test_kerr_call_mirror_matches_the_c_struct(struct, real):
    """Each ctypes mirror has KerrCall<T>'s members in order, its scalars
    of the instance's type, and the size the source asserts."""
    mirror = getattr(kk, struct)
    assert [f[0] for f in mirror._fields_] == _c_struct_fields()
    scalar = {"float": ctypes.c_float, "double": ctypes.c_double}[real]
    assert dict(mirror._fields_)["M"] is scalar
    sizes = dict(re.findall(r"sizeof\(KerrCall<(\w+)>\) == (\d+)",
                            SOURCE.read_text()))
    assert ctypes.sizeof(mirror) == int(sizes[real])


def test_kernels_build_without_contraction_or_fast_math():
    flags = _build.NVCC_FLAGS
    assert "-fmad=false" in flags and "-O3" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert any("sm_90a" in f for f in flags)


def test_peak_probe_writes_its_fmas():
    """Built with -fmad=false, the probe's chains time FMAs only because
    they write them out."""
    text = (_build.CSRC / "peak_probe.cu").read_text()
    assert "fmaf(x, y, z)" in text and "fma(x, y, z)" in text
    assert not re.search(r"= \w+(\[j\])? \* a \+ b;", text)


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32) \
        if t.is_floating_point() else t


def _rays(dtype, n=64):
    m = Kerr(M=1.0, a=0.9)
    ac = m.alpha_crit(R_OBS)
    rng = np.random.default_rng(3)
    al = torch.tensor(rng.uniform(0.5 * ac, 3 * ac, n), dtype=dtype)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=dtype)
    return m, al, th


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cpu_tensors_take_the_plain_shadow_loop(dtype):
    """On CPU tensors the shadow wrapper runs its plain loop: bitwise the
    plain loop's result, with the unconverged mask when asked for."""
    m, al, th = _rays(dtype)
    ref = torch.zeros(al.numel(), dtype=torch.bool)
    args = (m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 2000)
    want, want_unc = kk.trace_rays_kerr_plain(*args,
                                              return_unconverged=True)
    got, got_unc = kk.trace_rays_kerr_cuda(*args, return_unconverged=True)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(got_unc, want_unc)


@pytest.mark.parametrize("opaque, momentum", [(True, False), (False, True)],
                         ids=["opaque", "translucent, momenta"])
def test_cpu_tensors_take_the_plain_disk_loop(opaque, momentum):
    """On CPU tensors the disk wrapper runs its plain loop: bitwise the
    plain loop's statuses, hits, headings and hit records."""
    m, al, th = _rays(torch.float32)
    plane = (disk.r_isco(1.0, 0.9), 20.0, float(np.pi / 2), opaque)
    args = (m, R_OBS, al * 0.2, th, float(np.radians(80.0)), 5000.0, 2000,
            plane, 2)
    want = kk.trace_disk_rays_plain(*args, record_momentum=momentum)
    got = kk.trace_disk_rays_cuda(*args, record_momentum=momentum)
    for name in ("status", "n_hits", "xi", "final_alpha", "n_half"):
        assert torch.equal(_bits(getattr(got, name)),
                           _bits(getattr(want, name)))
    for name in ("r_hits", "phi_hits") + (("pr_hits", "pth_hits")
                                          if momentum else ()):
        assert len(getattr(got, name)) == len(getattr(want, name))
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert torch.equal(_bits(a), _bits(b))
    assert int(got.n_steps) == int(want.n_steps)
