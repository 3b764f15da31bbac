"""The port's observables (light_path_tracer_tpu_torch/observables.py)
against the JAX package's and the analytic Fourier oracles of its tests.

The same images, made with numpy from a seed, go through both packages on
the CPU. Tolerances: visibilities (complex128) and radial profiles to
1e-9 absolute (two FFT libraries, float64 images; float32 images to
1e-6); centroid tracks to 1e-12 rad in float64 (1e-6 relative in
float32); the host first-null search and the diameters exactly equal on
equal profiles. The oracles keep the JAX tests' own bounds.
"""

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import observables as jobs
from light_path_tracer_tpu_torch import observables as obs

FOV = (np.radians(20.0), np.radians(20.0))
N = 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _grid(n=N, fov=FOV):
    dm, dl = obs.pixel_scales((n, n), fov)
    x = (np.arange(n) - n / 2.0 + 0.5) * dl
    y = (np.arange(n) - n / 2.0 + 0.5) * dm
    return np.meshgrid(x, y)


def _images():
    rng = np.random.default_rng(7)
    l, m = _grid()
    d = np.radians(6.0)
    return {
        "random": rng.uniform(size=(N, N)),
        "disk": ((l ** 2 + m ** 2) < (d / 2) ** 2).astype(float),
        "rgb": rng.uniform(size=(48, 64, 3)),
        "float32": rng.uniform(size=(40, 40)).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["random", "disk", "rgb", "float32"])
def test_visibilities_and_profile_match_jax(name):
    img = _images()[name]
    tol = 1e-6 if img.dtype == np.float32 else 1e-9
    vj, uj, vvj = jobs.visibilities(img, FOV, pad=2)
    vt, ut, vvt = obs.visibilities(torch.from_numpy(img), FOV, pad=2)
    assert vt.dtype == torch.complex128 and vt.shape == vj.shape
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-15)
    np.testing.assert_allclose(vvt.numpy(), np.asarray(vvj), rtol=1e-15)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=tol)
    bj, aj = jobs.radial_profile(vj, uj, vvj, n_bins=64)
    bt, at = obs.radial_profile(vt, ut, vvt, n_bins=64)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-15)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=tol)


@pytest.mark.parametrize("model", ["disk", "ring"])
def test_shadow_diameter_matches_jax(model):
    img = _images()["disk"]
    ej, bj, (blj, aj) = jobs.shadow_diameter(img, FOV, model=model, pad=4,
                                             n_bins=256)
    et, bt, (blt, at) = obs.shadow_diameter(img, FOV, model=model, pad=4,
                                            n_bins=256)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-9)
    assert bt == pytest.approx(bj, rel=1e-9)
    assert et == pytest.approx(ej, rel=1e-9)


def test_point_source_flat_amplitude():
    img = np.zeros((N, N))
    img[N // 2, N // 2] = 1.0
    vis, _u, _v = obs.visibilities(img, FOV)
    assert np.allclose(np.abs(vis.numpy()), 1.0, atol=1e-6)


def test_total_flux_normalization_and_zero_image():
    img = np.random.default_rng(0).uniform(size=(N, N))
    vis, _u, _v = obs.visibilities(img, FOV)
    assert abs(vis[vis.shape[0] // 2, vis.shape[1] // 2] - 1.0) < 1e-6
    vis0, _, _ = obs.visibilities(np.zeros((N, N)), FOV)
    assert torch.all(vis0 == 0)


def test_gaussian_amplitude_law():
    l, m = _grid()
    sigma = np.radians(0.8)
    img = np.exp(-(l ** 2 + m ** 2) / (2 * sigma ** 2))
    vis, u, v = obs.visibilities(img, FOV, pad=2)
    b, a = (x.numpy() for x in obs.radial_profile(vis, u, v, n_bins=64))
    expect = np.exp(-2 * np.pi ** 2 * sigma ** 2 * b ** 2)
    sel = expect > 1e-3
    assert np.max(np.abs(a[sel] - expect[sel])) < 2e-2


@pytest.mark.parametrize("model,d_deg", [("ring", 6.0), ("disk", 8.0)])
def test_null_recovers_diameter(model, d_deg):
    l, m = _grid()
    d = np.radians(d_deg)
    r = np.sqrt(l ** 2 + m ** 2)
    _dm, dl = obs.pixel_scales((N, N), FOV)
    img = ((np.abs(r - d / 2) < dl) if model == "ring"
           else (r < d / 2)).astype(float)
    est, b_null, _ = obs.shadow_diameter(img, FOV, model=model, pad=8,
                                         n_bins=512)
    assert np.isfinite(b_null) and abs(est - d) / d < 0.03


def test_first_null_and_kernels():
    b = np.linspace(0, 10, 50)
    assert np.isnan(obs.first_null(b, np.exp(-b)))
    assert obs.disk_diameter_from_null(1.0) > obs.ring_diameter_from_null(
        1.0)
    assert obs.disk_diameter_from_null(2.0) == jobs.disk_diameter_from_null(
        2.0)
    amp = np.abs(np.cos(b))
    assert obs.first_null(b, amp) == jobs.first_null(b, amp)


def test_shadow_silhouette_end_to_end():
    """The analytic Schwarzschild shadow's silhouette inverts to
    2 alpha_crit within 5 %, as in the JAX package's test."""
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.models import make_metric
    from light_path_tracer_tpu_torch.pipeline import render_shadow
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    scene = SceneConfig(M=1.0, a=0.0, r_obs_mult=100.0,
                        vertical_fov_deg=16.0)
    image, _st = render_shadow(scene, (128, 128), analytic=True,
                               device="cpu")
    fov = camera.fov_from_vertical(scene.vertical_fov, (128, 128))
    est, b_null, _ = obs.shadow_diameter(1.0 - image, fov, model="disk",
                                         pad=8, n_bins=512)
    d_true = 2.0 * make_metric(1.0, 0.0, 0.0, 0.0).alpha_crit(100.0)
    assert np.isfinite(b_null) and abs(est - d_true) / d_true < 0.05


def test_visibility_at_matches_fft_grid_and_jax():
    img = np.random.default_rng(3).uniform(size=(64, 64))
    vis, u, v = obs.visibilities(img, FOV, pad=1)
    pts = np.array([[float(u[5]), float(v[9])], [12.5, -40.0]])
    direct = obs.visibility_at(img, FOV, pts).numpy()
    assert abs(direct[0] - vis[9, 5].item()) < 1e-8
    np.testing.assert_allclose(
        direct, np.asarray(jobs.visibility_at(img, FOV, pts)), atol=1e-12)


@pytest.mark.parametrize("case", ["point", "symmetric", "two points"])
def test_closure_phase_matches_jax_and_oracle(case):
    img = np.zeros((N, N))
    b1, b2 = (35.0, -8.0), (12.0, 20.0)
    if case == "point":
        img[N // 2 + 7, N // 2 - 11] = 1.0
    elif case == "symmetric":
        l, m = _grid()
        img = ((l ** 2 + m ** 2) < np.radians(3.0) ** 2).astype(float)
    else:
        img[N // 2 + 4, N // 2 + 10], img[N // 2 - 9, N // 2 - 3] = 2.0, 1.0
    cp = obs.closure_phase(img, FOV, b1, b2)
    cj = jobs.closure_phase(img, FOV, b1, b2)
    assert abs(np.angle(np.exp(1j * (cp - cj)))) < 1e-9
    if case == "point":
        assert abs(cp) < 1e-6
    elif case == "symmetric":
        assert min(abs(cp), abs(abs(cp) - np.pi)) < 1e-6


def test_pixel_scales_match_camera_focal_lengths():
    from light_path_tracer_tpu_torch.camera import focal_lengths
    shape, fov = (96, 160), (np.radians(24.0), np.radians(14.0))
    dm, dl = obs.pixel_scales(shape, fov)
    fx, fy = focal_lengths(shape, fov)
    assert (dl, dm) == (1.0 / fx, 1.0 / fy)
    assert (dm, dl) == jobs.pixel_scales(shape, fov)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_centroid_track_matches_jax(dtype):
    frames = np.random.default_rng(1).uniform(size=(4, 32, 24)).astype(
        dtype)
    tj = np.asarray(jobs.centroid_track(frames, FOV))
    tt = obs.centroid_track(torch.from_numpy(frames), FOV)
    assert tt.shape == (4, 2) and str(tt.dtype) == f"torch.{dtype}"
    if dtype == "float64":
        np.testing.assert_allclose(tt.numpy(), tj, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-6,
                                   atol=1e-6 * np.abs(tj).max())


def test_centroid_point_source_and_rgb():
    from light_path_tracer_tpu_torch.camera import focal_lengths
    img = np.zeros((N, N))
    img[37, 90] = 2.5
    track = obs.centroid_track(img, FOV).numpy()
    fx, fy = focal_lengths((N, N), FOV)
    assert track.shape == (2,)
    assert np.isclose(track[0], (90 - N / 2.0) / fx, atol=1e-12)
    assert np.isclose(track[1], (37 - N / 2.0) / fy, atol=1e-12)
    frames = np.random.default_rng(1).uniform(size=(2, 32, 32))
    rgb = np.zeros((2, 32, 32, 3))
    rgb[..., 1] = frames
    np.testing.assert_allclose(obs.centroid_track(rgb, FOV).numpy(),
                               obs.centroid_track(frames, FOV).numpy(),
                               atol=1e-12)
