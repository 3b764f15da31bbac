"""Config 4's near-axis ray in the port's plain loop against the JAX package.

The ray at row 959, col 511 of the aligned 1024^2 thin-disk grid (Kerr
a = 0.9, theta_obs 80 deg, vertical FOV 40 deg, opaque disk from the ISCO
to 20 M, float32 'fast') sits just off the polar axis. JAX's XLA path
finishes it in 51 attempts, escaped with no disk hit; the CUDA kernel on
the card ends it otherwise (PERF.md). The port's plain
loop on the CPU must reach JAX's result exactly: the same camera angles
bitwise, the same status, attempts and hit count. Its neighbours in the
row are held alike, so the pin does not rest on one ray.

The quarter-pixel-offset grid's seven near-axis lanes that froze on the
card while its kernel contracted a*b + c into FMA are held alike, capped
at QUARTER_CAP attempts (three of them run to the cap in both packages).
On four of them JAX and the plain loop end otherwise (ROADMAP Queue 3
#1): these cases are marked xfail with what each package does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import camera as jcamera
from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu_torch import camera, disk
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk

R_OBS = 100.0
THETA = float(np.radians(80.0))
DIM = (1024, 1024)
ROW = 959


@pytest.fixture(scope="module")
def grid():
    """The row's camera angles from both packages (float32)."""
    fov = camera.fov_from_vertical(np.radians(40.0), DIM)
    ja = np.asarray(jcamera.build_alpha_lookup(DIM, fov))[ROW]
    jt = np.asarray(jcamera.build_theta_lookup(DIM, fov))[ROW]
    pa = camera.build_alpha_lookup(DIM, fov, device="cpu")[ROW].numpy()
    pt = camera.build_theta_lookup(DIM, fov, device="cpu")[ROW].numpy()
    return ja, jt, pa, pt


@pytest.mark.parametrize("col,attempts", [(511, 51), (510, 51), (512, 17)])
def test_config4_ray_plain_loop_matches_jax(grid, col, attempts):
    ja, jt, pa, pt = grid
    assert pa.dtype == ja.dtype == np.float32
    assert pa[col] == ja[col] and pt[col] == jt[col]
    al, th = ja[col:col + 1], jt[col:col + 1]
    rj = jdisk.trace_disk_rays(
        JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
        5000.0, 200000, jdisk.DiskConfig(), backend="xla")
    plane = (disk.r_isco(1.0, 0.9), 20.0, float(np.pi / 2), True)
    rt = tk.trace_disk_rays_kerr(
        Kerr(M=1.0, a=0.9), R_OBS, torch.from_numpy(al.copy()),
        torch.from_numpy(th.copy()), THETA, 5000.0, 200000, plane, 2)
    assert int(np.asarray(rj.status)[0]) == int(rt.status[0]) == 1
    assert int(np.asarray(rj.n_hits)[0]) == int(rt.n_hits[0]) == 0
    # One ray: both packages' step counts are its attempts.
    assert int(np.asarray(rj.n_steps)) == int(rt.n_steps) == attempts


QUARTER_CAP = 1000


def _quarter_open(jax, plain):
    return pytest.mark.xfail(
        reason=f"ROADMAP Queue 3 #1: JAX ends this near-axis lane "
               f"{jax}, the plain loop {plain} (status, hits, attempts)")


@pytest.mark.parametrize("row,col", [
    pytest.param(181, 512, marks=_quarter_open((1, 0, 62), (1, 0, 63))),
    pytest.param(233, 512, marks=_quarter_open((1, 0, 65), (1, 0, 63))),
    pytest.param(447, 512, marks=_quarter_open((1, 1, 69), (1, 1, 76))),
    pytest.param(450, 512, marks=_quarter_open((-1, 0, 97),
                                               (1, 0, QUARTER_CAP))),
    (798, 512), (950, 511), (978, 511)])
def test_config4_quarter_offset_lane_plain_loop_matches_jax(row, col):
    """The quarter-offset 1024^2 config-4 grid's lane (row, col), one of
    the seven that froze on the card with FMA contraction: the plain loop
    and JAX from the same camera angles, capped at QUARTER_CAP attempts,
    end it with the same status, hit count and attempts."""
    fov = camera.fov_from_vertical(np.radians(40.0), DIM)
    off = (0.25, 0.25)
    ja = np.asarray(jcamera.build_alpha_lookup(DIM, fov, pixel_offset=off))
    jt = np.asarray(jcamera.build_theta_lookup(DIM, fov, pixel_offset=off))
    pa = camera.build_alpha_lookup(DIM, fov, pixel_offset=off,
                                   device="cpu").numpy()
    pt = camera.build_theta_lookup(DIM, fov, pixel_offset=off,
                                   device="cpu").numpy()
    assert pa[row, col] == ja[row, col] and pt[row, col] == jt[row, col]
    al, th = ja[row, col:col + 1], jt[row, col:col + 1]
    rj = jdisk.trace_disk_rays(
        JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
        5000.0, QUARTER_CAP, jdisk.DiskConfig(), backend="xla")
    plane = (disk.r_isco(1.0, 0.9), 20.0, float(np.pi / 2), True)
    rt = tk.trace_disk_rays_kerr(
        Kerr(M=1.0, a=0.9), R_OBS, torch.from_numpy(al.copy()),
        torch.from_numpy(th.copy()), THETA, 5000.0, QUARTER_CAP, plane, 2)
    got_j = (int(np.asarray(rj.status)[0]), int(np.asarray(rj.n_hits)[0]),
             int(np.asarray(rj.n_steps)))
    assert got_j == (int(rt.status[0]), int(rt.n_hits[0]), int(rt.n_steps))
