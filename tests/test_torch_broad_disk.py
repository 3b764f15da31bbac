"""Disk traces beyond the CUDA disk kernel's compiled widths (more than 8
crossing slots, more than two planes) through the port against the JAX
package, and the plane recorder's broad launch structures.

The same rays, made with numpy from a seed, go through both packages on
the CPU (the port's plain loop, which the CUDA wrappers run on CPU
tensors; on the card the slots beyond 8 go through the plane recorder as
one equatorial plane and three or more planes through its broad
instances, held bitwise against the plain loop by chip_smoke.py phase
26). Rays: 128 random ones (alpha in [0.01, 0.12], a = 0); for the 10
slots in float64, 96 of them moved just outside the critical curve
(alpha_crit (1 + eps), eps log-uniform in [1e-13, 1e-1]) and traced at
atol = rtol = 1e-12, so rays wind and cross a translucent plane more
than 8 times (float32 rounding ends a winding within a few crossings).
Tolerances: float64, identical statuses and hit counts, and every
recorded r, phi, xi and momentum within 1e-8 of each slot's largest
value on the random rays (as tests/test_torch_disk.py's; read 2.2e-9 at
most); on the
winding rays within 1e-6 in the first five slots and 1e-2 in the later
ones: each half orbit near the photon sphere multiplies a difference
between two integrations by about e^pi, so the slots part by 10-30 times
a slot (two seeds: slot 0 read 1e-9 at most, slot 4 4e-7, slot 9 1e-3);
float32, as
tests/test_torch_disk.py's: statuses and hit counts agree on > 0.98 of
the rays and the first slot's median |dr| < 1e-3.
"""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu_torch import disk
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk

R_OBS = 100.0
THETA = float(np.radians(80.0))
SLOTS = 10
# float64 at tight tolerances, so a winding ray's integration error stays
# below its offset from the critical curve and it winds long enough
PRECISION = {"float64": "tol:1e-12", "float32": "fast"}
# three translucent planes: the equator, a tilted plane and a warped one
PLANES = (dict(r_in=3.0, r_out=20.0, opaque=False, max_hits=SLOTS),
          dict(r_in=3.0, r_out=20.0, tilt=0.5, tilt_azimuth=0.7,
               opaque=False, max_hits=SLOTS),
          dict(r_in=4.0, r_out=24.0, tilt=0.4, tilt_azimuth=-1.0,
               warp_radius=10.0, opaque=False, max_hits=SLOTS))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rays(dtype, winding=False):
    """128 random rays; with winding, 96 of them moved just outside the
    critical curve."""
    ac = JKerr(M=1.0, a=0.0).alpha_crit(R_OBS, THETA)
    rng = np.random.default_rng(26)
    al = rng.uniform(0.01, 0.12, 128)
    if winding:
        al[:96] = ac * (1.0 + 10.0 ** rng.uniform(-13.0, -1.0, 96))
    th = rng.uniform(-np.pi, np.pi, 128)
    return al.astype(dtype), th.astype(dtype)


def _check(rt, rj, dtype, fields, bars=(1e-8, 1e-8)):
    """bars: float64's bars relative to each slot's largest value, of the
    first five slots and of the later ones."""
    st, sj = _np(rt.status), _np(rj.status)
    nt, nj = _np(rt.n_hits), _np(rj.n_hits)
    if dtype == "float64":
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(nt, nj)
        for name in fields:
            assert len(getattr(rt, name)) == len(getattr(rj, name))
            for k, (x, y) in enumerate(zip(getattr(rt, name),
                                            getattr(rj, name))):
                y = _np(y)
                bar = bars[0] if k < 5 else bars[1]
                assert np.abs(_np(x) - y).max() <= bar * np.abs(y).max()
        return
    assert (st == sj).mean() > 0.98 and (nt == nj).mean() > 0.98
    both = (nt > 0) & (nj > 0)
    assert np.median(np.abs(_np(rt.r_hits[0]) - _np(rj.r_hits[0]))[both]) \
        < 1e-3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ten_slots_match_jax(dtype):
    al, th = _rays(dtype, winding=dtype == "float64")
    cfg = PLANES[0]
    rj = jdisk.trace_disk_rays(
        JKerr(M=1.0, a=0.0), R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
        5000.0, 20000, jdisk.DiskConfig(**cfg), backend="xla",
        precision=PRECISION[dtype], record_momentum=True)
    rt = disk.trace_disk_rays(
        Kerr(M=1.0, a=0.0), R_OBS, torch.from_numpy(al),
        torch.from_numpy(th), THETA, 5000.0, 20000, disk.DiskConfig(**cfg),
        precision=PRECISION[dtype], record_momentum=True)
    assert len(rt.r_hits) == len(rt.pr_hits) == SLOTS
    assert int(rt.n_hits.max()) > (8 if dtype == "float64" else 1)
    _check(rt, rj, dtype, ("r_hits", "phi_hits", "pr_hits", "pth_hits"),
           bars=(1e-6, 1e-2) if dtype == "float64" else None)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_three_planes_match_jax(dtype):
    al, th = _rays(dtype)
    rj = jdisk.trace_disk_rays_multi(
        JKerr(M=1.0, a=0.0), R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
        5000.0, 20000, [jdisk.DiskConfig(**c) for c in PLANES],
        precision=PRECISION[dtype])
    rt = disk.trace_disk_rays_multi(
        Kerr(M=1.0, a=0.0), R_OBS, torch.from_numpy(al),
        torch.from_numpy(th), THETA, 5000.0, 20000,
        [disk.DiskConfig(**c) for c in PLANES], precision=PRECISION[dtype],
        two_pass=False)
    assert len(rt) == len(rj) == 3
    for a, b in zip(rt, rj):
        assert int((a.n_hits > 0).sum()) > 10
        _check(a, b, dtype, ("r_hits", "phi_hits", "xi_hits"))


def test_plane_list_layout():
    """The broad plane recorder's PlaneList mirrors csrc/kerr_planes.cuh
    (its static_assert), and a PlaneSpec table packs as the kernel reads
    it: 200 bytes a plane."""
    assert ctypes.sizeof(kk.PlaneList) == 40
    specs = [kk.PlaneSpec(kind=k, r_in=float(k)) for k in range(3)]
    table = bytes((kk.PlaneSpec * 3)(*specs))
    assert len(table) == 600
    assert kk.PlaneSpec.from_buffer_copy(table[400:600]).kind == 2
    assert kk.MAX_KERNEL_PLANES == 2 and "broad" in kk.VARIANTS
