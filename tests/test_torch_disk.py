"""The PyTorch port's thin-disk path (config 4) against the JAX package.

The same rays, made with numpy from a seed, go through the JAX package's
disk trace (`trace_disk_rays(..., backend="xla")`, or the Pallas kernel in
interpret mode) and the port's plain loop on the CPU. Criteria:
  * float64: identical statuses and hit counts, |d r_hits| and
    |d phi_hits| < 1e-8 on every recorded crossing, xi to 1e-12;
  * float32: n_hits agreement > 0.98, median |d final_alpha| < 1e-4 on
    escaped rays with no hit, and median |d r_hits[0]| < 1e-3 M on rays
    hit in both. The last is looser than the other two because the
    packages' float32 sin/cos differ by an ulp, and near-critical rays
    amplify that into different step sequences (measured median
    2.4e-4 to 3.1e-4 M over four seeds); each package's own float32
    crossing radii sit ~4e-2 M (median) from its float64 ones.
  * the physics helpers (ISCO, Keplerian redshift, temperature profile)
    to 1e-12; blackbody_rgb bitwise where both packages' float32 log
    agree, and to 2e-6 where XLA's float32 log is an ulp off;
  * render_disk at 32x48: equal disk_pixels and captured and image max
    |d| < 1e-6 in float64 (the image is float32); in float32 the disk
    masks agree on >= 99 % of pixels.
The two-pass driver on the plain loop equals the single pass exactly,
and rays beyond `slots` keep their first-pass record. The CUDA kernel
against this loop runs on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import camera, disk
from light_path_tracer_tpu_torch.convert import (disk_config_from_jax,
                                                 render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops import kerr_trace as tk
from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
from light_path_tracer_tpu_torch.utils.config import RenderConfig

R_OBS = 100.0
THETA = float(np.radians(80.0))
R_IN = disk.r_isco(1.0, 0.9)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.01, 0.12, n), rng.uniform(-np.pi, np.pi, n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("opaque,momentum", [(True, False), (False, True),
                                             (True, True), (False, False)])
def test_plain_disk_trace_matches_jax(dtype, opaque, momentum):
    al, th = _rays(256, 21)
    npdt = np.dtype(dtype)
    rj = jdisk.trace_disk_rays(
        JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al, npdt),
        jnp.asarray(th, npdt), THETA, 5000.0, 20000,
        jdisk.DiskConfig(opaque=opaque), backend="xla",
        record_momentum=momentum)
    plane = (R_IN, 20.0, float(np.pi / 2), opaque)
    rt = tk.trace_disk_rays_kerr(
        Kerr(M=1.0, a=0.9), R_OBS, torch.from_numpy(al.astype(npdt)),
        torch.from_numpy(th.astype(npdt)), THETA, 5000.0, 20000, plane, 2,
        record_momentum=momentum)
    assert rt.r_hits[0].dtype == getattr(torch, dtype)
    assert len(rt.pr_hits) == len(rt.pth_hits) == (2 if momentum else 0)
    nj, nt = _np(rj.n_hits), _np(rt.n_hits)
    fj, ft = _np(rj.final_alpha), _np(rt.final_alpha)
    free = (nj == 0) & (nt == 0) & np.isfinite(fj) & np.isfinite(ft)
    assert (nt > 0).sum() > 150 and free.sum() > 20
    if not opaque:
        assert (nt > 1).sum() > 5
    if dtype == "float64":
        np.testing.assert_array_equal(_np(rt.status), _np(rj.status))
        np.testing.assert_array_equal(nt, nj)
        np.testing.assert_allclose(_np(rt.xi), _np(rj.xi), rtol=0,
                                   atol=1e-12)
        slots = [("r_hits", "r_hits"), ("phi_hits", "phi_hits")]
        if momentum:
            slots += [("pr_hits", "pr_hits"), ("pth_hits", "pth_hits")]
        for name, _ in slots:
            for k, (a, b) in enumerate(zip(getattr(rj, name),
                                           getattr(rt, name))):
                hit = nt > k
                d = np.abs(_np(a)[hit] - _np(b)[hit])
                assert d.size == 0 or d.max() < 1e-8, (name, k, d.max())
        assert np.abs(fj[free] - ft[free]).max() < 1e-8
    else:
        assert (nj == nt).mean() > 0.98
        both = (nj > 0) & (nt > 0)
        d = np.abs(_np(rj.r_hits[0])[both] - _np(rt.r_hits[0])[both])
        assert np.median(d) < 1e-3
        assert np.median(np.abs(fj[free] - ft[free])) < 1e-4


def test_plain_disk_trace_matches_pallas_interpret():
    """The Pallas tile kernel itself, in interpret mode (one (8, 128)
    tile), on 32 rays."""
    from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
        trace_disk_rays_pallas)
    al, th = _rays(32, 3)
    al, th = al.astype(np.float32), th.astype(np.float32)
    plane = (R_IN, 20.0, float(np.pi / 2), True)
    rp = trace_disk_rays_pallas(
        JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
        5000.0, 5000, plane, 2, tile_rows=8, interpret=True)
    rt = tk.trace_disk_rays_kerr(Kerr(M=1.0, a=0.9), R_OBS,
                                 torch.from_numpy(al), torch.from_numpy(th),
                                 THETA, 5000.0, 5000, plane, 2)
    np.testing.assert_array_equal(_np(rt.status), _np(rp.status))
    np.testing.assert_array_equal(_np(rt.n_hits), _np(rp.n_hits))
    hit = _np(rt.n_hits) > 0
    assert hit.sum() > 15
    d = np.abs(_np(rt.r_hits[0])[hit] - _np(rp.r_hits[0])[hit])
    assert np.median(d) < 1e-3


def test_center_column_crossings_after_polar_pass():
    """The L = 0 centre-column rays pass over the pole and hit the plane
    at theta = -pi/2; the cos(theta) detector sees them (a theta - pi/2
    detector leaves a dark one-pixel seam), as in the JAX package."""
    dim = (48, 49)                  # odd width: column 24 is central
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    grid = dict(dtype=torch.float64, device="cpu")
    al = camera.build_alpha_lookup(dim, fov, **grid).reshape(-1)
    th = camera.build_theta_lookup(dim, fov, **grid).reshape(-1)
    res = disk.trace_disk_rays(Kerr(M=1.0, a=0.9), R_OBS, al, th, THETA,
                               5000.0, 200000, disk.DiskConfig())
    hits_per_col = (res.n_hits.reshape(dim) > 0).sum(dim=0)
    assert int(hits_per_col[24]) >= 0.8 * int(hits_per_col[23])
    assert int(hits_per_col[24]) >= 0.8 * int(hits_per_col[25]) > 0


@pytest.mark.parametrize("prograde", [True, False])
def test_physics_helpers_match_jax(prograde):
    r = np.linspace(1.8, 40.0, 301)
    xi = np.linspace(-8.0, 8.0, 301)
    for M, a, Q in ((1.0, 0.9, 0.0), (1.0, 0.0, 0.0), (2.0, 0.5, 0.0),
                    (1.0, 0.3, 0.4)):
        gj = jdisk.keplerian_redshift(M, a, jnp.asarray(r),
                                      jnp.asarray(xi), prograde, Q=Q)
        gt = disk.keplerian_redshift(M, a, torch.from_numpy(r),
                                     torch.from_numpy(xi), prograde, Q=Q)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-12)
        assert disk.r_isco(M, a, prograde, Q=Q) == pytest.approx(
            jdisk.r_isco(M, a, prograde, Q=Q), abs=1e-12)
    r_in = disk.r_isco(1.0, 0.9, prograde)
    tj = jdisk.disk_temperature(jnp.asarray(r), r_in, 9000.0)
    tt = disk.disk_temperature(torch.from_numpy(r), r_in, 9000.0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-12,
                               atol=1e-12)


def test_blackbody_rgb_matches_jax():
    from light_path_tracer_tpu.utils import color as jcolor
    from light_path_tracer_tpu_torch.utils import color
    T = np.geomspace(300.0, 80000.0, 2000)
    cj = np.asarray(jcolor.blackbody_rgb(T))
    ct = color.blackbody_rgb(torch.from_numpy(T))
    assert ct.dtype == torch.float32 and ct.shape == (2000, 3)
    lj = np.asarray(jnp.log(jnp.clip(jnp.asarray(T, jnp.float32), 500.0,
                                     60000.0)))
    lt = torch.log(torch.clamp(torch.from_numpy(T).float(), 500.0,
                               60000.0)).numpy()
    same_log = lj == lt
    assert same_log.mean() > 0.95
    d = np.abs(ct.numpy() - cj)
    assert d[same_log].max() <= 1e-12
    assert d.max() < 2e-6
    for t in (2000.0, 6500.0, 10000.0):
        assert color.blackbody_chromaticity(t) == pytest.approx(
            jcolor.blackbody_chromaticity(t), abs=1e-12)


@pytest.mark.parametrize("dtype,spectrum,opaque", [
    ("float64", "powerlaw", True), ("float64", "blackbody", False),
    ("float32", "powerlaw", True), ("float32", "blackbody", False)])
def test_render_disk_matches_jax(dtype, spectrum, opaque):
    jscene = JScene(M=1.0, a=0.9, r_obs_mult=R_OBS, vertical_fov_deg=30.0,
                    theta_obs=THETA)
    jcfg = JRender(dtype=dtype, backend="xla")
    jd = jdisk.DiskConfig(spectrum=spectrum, opaque=opaque)
    dim = (32, 48)
    jimg, jst = jdisk.render_disk(jscene, dim, jcfg, jd)
    timg, tst = disk.render_disk(scene_from_jax(jscene), dim,
                                 render_cfg_from_jax(jcfg),
                                 disk_config_from_jax(jd), device="cpu")
    jimg = np.asarray(jimg)
    assert timg.dtype == torch.float32 and timg.shape == jimg.shape
    assert 0.0 <= float(timg.min()) and float(timg.max()) <= 1.0
    for key in ("alpha_crit", "r_isco", "total_rays", "traced_rays"):
        assert tst[key] == jst[key]
    assert set(tst["timings"]) == {"build_lookup", "precompute", "render",
                                   "total"}
    assert tst["integrator_steps"] > 0 and tst["disk_pixels"] > 100
    if dtype == "float64":
        assert tst["disk_pixels"] == jst["disk_pixels"]
        assert tst["captured"] == jst["captured"]
        assert np.abs(timg.numpy() - jimg).max() < 1e-6
    else:
        lum = (lambda x: x.sum(-1)) if spectrum == "blackbody" else (
            lambda x: x)
        mask_j, mask_t = lum(jimg) > 0, lum(timg.numpy()) > 0
        assert (mask_j == mask_t).mean() >= 0.99


def _grid(dim, offset=(0.0, 0.0)):
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    grid = dict(dtype=torch.float32, device="cpu", pixel_offset=offset)
    return (camera.build_alpha_lookup(dim, fov, **grid).reshape(-1),
            camera.build_theta_lookup(dim, fov, **grid).reshape(-1))


def _records(res):
    return [res.status, res.n_hits, res.final_alpha.nan_to_num(9.0),
            *res.r_hits, *res.phi_hits, *res.pr_hits, *res.pth_hits]


@pytest.mark.parametrize("pass1_steps", [8, 64])
def test_disk_two_pass_equals_single_pass(pass1_steps):
    al, th = _grid((32, 32))
    m = Kerr(M=1.0, a=0.9)
    plane = (R_IN, 20.0, float(np.pi / 2), False)
    args = (m, R_OBS, al, th, THETA, 5000.0, 20000, plane, 2)
    one = kk.trace_disk_rays_cuda(*args, record_momentum=True)
    _, unconv = kk.trace_disk_rays_cuda(*args[:6], pass1_steps, plane, 2,
                                        return_unconverged=True)
    assert 0 < int(unconv.sum()) <= 1024
    launches = kk.trace_disk_rays_two_pass.launches
    two = kk.trace_disk_rays_two_pass(*args, pass1_steps=pass1_steps,
                                      record_momentum=True)
    assert kk.trace_disk_rays_two_pass.launches == launches + 1
    for a, b in zip(_records(one), _records(two)):
        assert torch.equal(a, b)
    assert torch.equal(one.xi, two.xi)
    assert int(two.n_steps) > int(one.n_steps)


def test_disk_two_pass_keeps_pass_one_beyond_slots():
    al, th = _grid((32, 32))
    m = Kerr(M=1.0, a=0.9)
    plane = (R_IN, 20.0, float(np.pi / 2), True)
    args = (m, R_OBS, al, th, THETA, 5000.0, 20000, plane, 2)
    one = kk.trace_disk_rays_cuda(*args)
    first, unconv = kk.trace_disk_rays_cuda(*args[:6], 8, plane, 2,
                                            return_unconverged=True)
    idx = torch.nonzero(unconv)[:, 0]
    assert idx.numel() > 64
    two = kk.trace_disk_rays_two_pass(*args, pass1_steps=8, slots=64)
    retraced = torch.zeros_like(unconv)
    retraced[idx[:64]] = True
    for a, b, c in zip(_records(one), _records(two), _records(first)):
        assert torch.equal(b[retraced], a[retraced])
        assert torch.equal(b[~retraced], c[~retraced])


def test_trace_disk_rays_rejects_modes_not_ported():
    # The time recorder and tilted and warped planes are ported
    # (tests/test_torch_tilted_disk.py, test_torch_light_travel_delay.py
    # hold them against JAX): here they fill their records. An unknown
    # pair or backend is still a ValueError.
    m = Kerr(M=1.0, a=0.9)
    al = torch.full((4,), 0.05, dtype=torch.float64)
    args = (m, R_OBS, al, al, THETA, 5000.0, 100)
    res = disk.trace_disk_rays(*args, disk.DiskConfig(), record_time=True)
    assert len(res.t_hits) == 2 and res.t_end.shape == (4,)
    for cfg in (disk.DiskConfig(tilt=0.1), disk.DiskConfig(warp_radius=5.0)):
        res = disk.trace_disk_rays(*args, cfg)
        assert len(res.xi_hits) == 2 and res.t_hits == ()
    with pytest.raises(ValueError):
        disk.trace_disk_rays(*args, disk.DiskConfig(), method="rk4")
    with pytest.raises(ValueError):
        disk.trace_disk_rays(*args, disk.DiskConfig(), backend="pallas")
    # A camera Doppler factor multiplies the shift: g^p scales by d^p.
    scene = scene_from_jax(JScene(M=1.0, a=0.9, Q=0.2))
    r = torch.full((4,), 8.0, dtype=torch.float64)
    hits = torch.ones(4, dtype=torch.int32)
    still, _ = disk.disk_emission(scene, disk.DiskConfig(), R_IN, hits,
                                  (r, r), al)
    moving, _ = disk.disk_emission(scene, disk.DiskConfig(), R_IN, hits,
                                   (r, r), al, doppler=torch.full_like(r, 2.0))
    torch.testing.assert_close(moving, still * 8.0, rtol=1e-12, atol=0)


def test_disk_emission_options():
    """per_slot sums to the default, annulus masks radii, a pattern
    multiplies each crossing (evaluated at the retarded time)."""
    scene = scene_from_jax(JScene(M=1.0, a=0.9))
    cfg = disk.DiskConfig(opaque=False)
    n = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    r = (torch.tensor([0.0, 5.0, 3.0, 12.0], dtype=torch.float64),
         torch.tensor([0.0, 0.0, 8.0, 15.0], dtype=torch.float64))
    phi = (torch.zeros(4, dtype=torch.float64),) * 2
    xi = torch.tensor([0.0, 2.0, -3.0, 1.0], dtype=torch.float64)
    total, rgb = disk.disk_emission(scene, cfg, R_IN, n, r, xi)
    slots, _ = disk.disk_emission(scene, cfg, R_IN, n, r, xi, per_slot=True)
    assert rgb is None and slots.shape == (2, 4)
    torch.testing.assert_close(slots.sum(0), total, rtol=0, atol=0)
    assert float(total[0]) == 0.0 and float(slots[1, 1]) == 0.0
    ring, _ = disk.disk_emission(scene, cfg, R_IN, n, r, xi,
                                 annulus=(4.0, 10.0))
    torch.testing.assert_close(ring, slots[0] * torch.tensor(
        [0.0, 1.0, 0.0, 0.0], dtype=torch.float64) + slots[1] * torch.tensor(
        [0.0, 0.0, 1.0, 0.0], dtype=torch.float64))
    seen = []

    def pattern(rc, ph, t):
        seen.append(t)
        return 2.0

    doubled, _ = disk.disk_emission(scene, cfg, R_IN, n, r, xi,
                                    pattern=pattern, phi_hits=phi, t=5.0,
                                    delay_hits=(1.0, 2.0))
    torch.testing.assert_close(doubled, 2.0 * total)
    assert seen == [4.0, 3.0]


def test_disk_config_from_jax_round_trips():
    jd = jdisk.DiskConfig(r_out=30.0, r_in=4.0, emissivity_index=2.5,
                          g_power=4.0, opaque=False, prograde=False,
                          max_hits=3, tone_map="sqrt", spectrum="blackbody",
                          t_peak=12000.0)
    td = disk_config_from_jax(jd)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert [f.name for f in dataclasses.fields(td)] == [
        f.name for f in dataclasses.fields(jd)]
    assert disk_config_from_jax(jdisk.DiskConfig()) == disk.DiskConfig()


def test_afmhot_table_matches_matplotlib():
    cm = pytest.importorskip("matplotlib.cm")
    from light_path_tracer_tpu_torch.utils.save import AFMHOT
    np.testing.assert_array_equal(AFMHOT, cm.afmhot(np.arange(256))[:, :3])


def test_cli_disk_on_cpu(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png
    out = tmp_path / "d.png"
    rc = main(["disk", "--size", "32", "--a", "0.9", "--device", "cpu",
               "--output", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Accretion disk: 32x32, a=0.9, inclination 80.0 deg" in text
    assert "disk pixels: " in text and "rays/s" in text
    img = read_png(out)
    assert img.shape == (32, 32, 3) and img.max() > 0.5
    # afmhot: red leads green leads blue on every pixel
    assert (img[..., 0] >= img[..., 1]).all()
    assert (img[..., 1] >= img[..., 2]).all()
    out2 = tmp_path / "bb.png"
    assert main(["disk", "--size", "16", "--a", "0.9", "--device", "cpu",
                 "--spectrum", "blackbody", "--translucent",
                 "--output", str(out2)]) == 0
    assert read_png(out2).shape == (16, 16, 3)


def test_cli_disk_charged_on_cpu(tmp_path, capsys):
    """--Q renders the Kerr-Newman disk (at a = 0 too) and prints the
    charge; --eps3 is ignored with the JAX package's note."""
    from light_path_tracer_tpu_torch.cli import main
    from light_path_tracer_tpu_torch.utils.save import read_png
    for flags in (["--a", "0.6", "--Q", "0.6"], ["--Q", "0.5"]):
        out = tmp_path / "q.png"
        assert main(["disk", "--size", "16", "--device", "cpu",
                     "--output", str(out), *flags]) == 0
        text = capsys.readouterr().out
        assert f"Q={flags[-1]}, inclination 80.0 deg" in text
        isco = disk.r_isco(1.0, float(flags[1]) if len(flags) > 2 else 0.0,
                           Q=float(flags[-1]))
        assert f"r_isco={isco:.3f} M" in text
        img = read_png(out)
        assert img.shape == (16, 16, 3) and img.max() > 0.5
    assert main(["disk", "--size", "8", "--a", "0.5", "--eps3", "1",
                 "--device", "cpu", "--output",
                 str(tmp_path / "e.png")]) == 0
    assert "not wired for --eps3" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--light-curve", "x.png", "--light-travel-delay"], ["--disk2"],
    ["--multihost"], ["--visibility", "x.npz"],
    ["--frames", "4", "--centroid", "x.png"],
    ["--tilt", "10"], ["--warp-radius", "8"],
    ["--boost", "0.1", "0", "0"]])
def test_cli_disk_rejects_modes_not_ported(tmp_path, flags):
    # Every flag but --multihost is ported and runs; --multihost raises.
    from light_path_tracer_tpu_torch.cli import main
    argv = ["disk", "--size", "8", "--device", "cpu",
            "--output", str(tmp_path / "d.png"),
            *(str(tmp_path / f) if f.endswith((".png", ".npz")) else f
              for f in flags)]
    if flags == ["--multihost"]:
        with pytest.raises(NotImplementedError):
            main(argv)
    else:
        assert main(argv) == 0


def test_disk_parser_defaults_match_jax():
    import argparse
    from light_path_tracer_tpu.cli import disk as jcli
    from light_path_tracer_tpu_torch.cli import disk as tcli

    def defaults(mod):
        parser = argparse.ArgumentParser()
        mod.register(parser.add_subparsers(dest="command"))
        return vars(parser.parse_args(["disk"]))

    dj, dt = defaults(jcli), defaults(tcli)
    dj.pop("fn"), dt.pop("fn")
    shared = {"device", "bilinear", "sampling", "metric_py"}
    for key in set(dj) - shared:
        assert key in dt, key
        assert dt[key] == dj[key], key
