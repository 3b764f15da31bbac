"""The PyTorch port's camera grids against the JAX package's.

Both build the same (24, 40) grids from the same FOV; the JAX reference
runs on the CPU with x64 enabled (tests/conftest.py), where its float32
grids are float64 computations rounded once, as the port's are.
Tolerances: float64 to 1e-12 rad absolute; float32 to 2 ulp of pi
(the largest |theta|).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import camera as jcam
from light_path_tracer_tpu_torch import camera as tcam

DIM = (24, 40)
PSIS = [(0.0, 0.0), (0.05, -0.08)]
F32_TOL = 2 * float(np.spacing(np.float32(np.pi)))
TOL = {"float64": 1e-12, "float32": F32_TOL}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fov():
    return jcam.fov_from_vertical(np.radians(30.0), DIM)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("psi", PSIS)
def test_alpha_lookup_matches_jax(psi, dtype):
    fov = _fov()
    ref = np.asarray(jcam.build_alpha_lookup(DIM, fov, psi=psi,
                                             dtype=jnp.dtype(dtype)))
    got = tcam.build_alpha_lookup(DIM, fov, psi=psi,
                                  dtype=getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == DIM
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("psi", PSIS)
def test_theta_lookup_matches_jax(psi, dtype):
    fov = _fov()
    ref = np.asarray(jcam.build_theta_lookup(DIM, fov, psi=psi,
                                             dtype=jnp.dtype(dtype)))
    got = tcam.build_theta_lookup(DIM, fov, psi=psi,
                                  dtype=getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == DIM
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("psi", PSIS + [(0.0, 0.2)])
def test_axis_refine_columns_match_jax(psi):
    fov = _fov()
    ref = np.asarray(jcam.axis_refine_columns(DIM, fov, psi=psi))
    got = tcam.axis_refine_columns(DIM, fov, psi=psi, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any()


def test_host_geometry_matches_jax():
    fov = _fov()
    assert tcam.fov_from_vertical(np.radians(30.0), DIM) == tuple(fov)
    assert tcam.focal_lengths(DIM, fov) == tuple(jcam.focal_lengths(DIM, fov))
    for psi in PSIS:
        jf, tf = jcam.psi_frame(psi), tcam.psi_frame(psi)
        for a, b in zip(jf[:3], tf[:3]):
            np.testing.assert_array_equal(a, b)
        assert tcam.psi_to_cam_projection(psi) == jcam.psi_to_cam_projection(
            psi)


def test_boost_and_decimals_are_not_ported():
    # The boost is ported (tests/test_torch_aberration.py holds it against
    # JAX); alpha rounding (decimals) still raises.
    fov = _fov()
    ref = np.asarray(jcam.build_alpha_lookup(DIM, fov, boost=(0.0, 0.0, 0.3),
                                             dtype=jnp.float64))
    got = tcam.build_alpha_lookup(DIM, fov, boost=(0.0, 0.0, 0.3),
                                  dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    with pytest.raises(NotImplementedError):
        tcam.build_alpha_lookup(DIM, fov, decimals=3, device="cpu")
