"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Gates as chip_smoke.py. Kerr DP45: status agreement above 0.99 and p99
|d final_alpha| < 2e-3 on stable escaped rays (the kernels build without
FMA contraction, but the card's sinf, cosf and powf round otherwise than
the CPU's, so step sequences differ at the tolerance level). Orbit RK4 (fixed steps, so only roundings differ):
status agreement above 0.999, p99 |d final_alpha| < 1e-4 on stable
escaped rays, the alpha = 0 lane INVALID. The lensed render on the card
against the CPU: shadow masks agree on >= 99 %, bilinear image RMSE
< 1e-3 on pixels of winding < 2. The disk variant against its plain loop:
status and n_hits agreement above 0.99, on rays hit in both median
|d r_hits[0]| < 1e-3 M and p99 < 0.1 M (step sequences differ, as for
the shadow), median |d final_alpha| < 1e-4 on escaped no-hit rays. Both
two-pass drivers equal a single pass bitwise (the kernel computes each
ray on its own thread). The extras kernel (volumetric thin, absorbed and
jet, spectral) against its plain loop: status agreement above 0.99, p99
|d emission| / max < 1e-3 and p99 |d tau| < 1e-3; its drivers equal a
single pass bitwise; the volumetric render on the card against the CPU:
emission masks >= 99 %, median |d image| < 1e-4. The Stokes, movie and
order forms against their plain loops: status agreement above 0.99, the
Stokes form bitwise in both pairs and dtypes (its kernel sums the
contraction in the plain loop's order), the
Stokes and movie extras p99 |d| / max < 1e-3 (Q and U against max |I|),
the order buckets by their sum per ray (p99 < 1e-3 of the largest) since
floor(m) switches within rounding of an integer; the aux driver bitwise
equal to the single pass; the three renders on the card against the CPU.
The peak probe's chains against the same recurrence in torch: float64
within 4 k ulp (the kernel's FMA rounds once, torch twice), float32
within 4 k ulp, sinf within 4 ulp. Each family's float64 instance against
the plain float64 loop (the gates of chip_smoke.py phase 17), and the
exact-cycle exit bitwise against the same kernel grinding every attempt
on near-axis lanes that freeze. Config 4's rays (959, 510..512) as JAX
ends them; the quarter-offset grid's near-axis lanes and the order lane
(171, 129) as the plain loop on the CPU ends them (the lanes still left
open in ROADMAP Queue 3 are xfail with what each side does); the Kerr
kernel's warp step sum and unconverged flags against its per-ray
attempts and raw statuses, and its in-kernel extraction against
finalize_angles on the same final states. Config 5's path: the chunked
trace_batch, sorted and unsorted, bitwise equal to the whole batch on
65,536 jittered rays; adaptive AA equal to uniform AA at 256^2; the AA
renders at 48x64 on the card against the CPU (shadow images equal on
>= 99 %, lensed bilinear RMSE < 1e-3 on pixels of winding < 2).
Kerr-Newman and Johannsen-Psaltis through the Kerr kernel: each family's
shadow instance against the plain loop in float32 (the Kerr gates) and
float64 (phase 17's), the Kerr-Newman disk variant (the disk gates), a
Kerr-Newman metric at Q = 0 bitwise the Kerr kernel, Johannsen-Psaltis's
float64 alpha_crit bisection on the card within 1e-9 rad of the CPU's,
and each family's shadow render on the card against the CPU. DOP853
(csrc/kerr_dop853*.cu): each family's Kerr instance (Kerr with Hermite
and linear events, Kerr-Newman, Johannsen-Psaltis), the disk variant
and each extras functor at its main path's width (and the 2-band
spectrum, which phase 22 of chip_smoke.py leaves out), in float32 and
float64, against the plain DOP853 loop by its DP45 twin's gates, every
DOP853 extras instance at its block bound, a 64^2 float64 DOP853 render
on the card against the CPU, and a CUDA tensor with an unknown pair or
interpolant raising without falling back. The mu chart: each mu instance
(Kerr, Kerr-Newman; float32, float64; DP45, DOP853) bitwise the plain mu
loop on the card with the poison mask, the CUDA hybrid bitwise the same
driver over the plain loop, a 64^2 float64 mu render on the card against
the CPU, and the chart raising where it has no instance. The Kerr-Newman
flow of the extras kernel: its instances at the main paths' widths
against the plain loop (both pairs and dtypes), each at its block bound,
and a 64^2 float64 charged volumetric render on the card against the
CPU. The disk variant's wide instances (5 to 8 slots): their first 4
slots bitwise the 4-slot instance's and every slot against the plain loop
(the disk gates) for each pair, dtype, family and momentum, 9 slots
raising before a launch; and each disk mode of chip_smoke.py phase 24 at
64^2 on the card against the CPU (disk masks >= 99 %, median |d| < 1e-3
on disk pixels, the 1-D outputs within 1e-3 of their largest value, Q
and U of the largest I). The plane recorder (tilted, warped and second
planes, crossing times; csrc/kerr_planes.cuh): each instance (both
pairs, dtypes and families) on phase 25's plane sets bitwise its plain
loop on the card, the equatorial plane through it bitwise the disk
variant, three planes raising before a launch; and each mode of
chip_smoke.py phase 25 (tilted, warped and second disks, the delayed
light curve, the boosted disk, shadow, lens and volumetric renders) at
64^2 on the card against the CPU by its gates. The surface kernel
(csrc/kerr_surface.cuh): each instance (both pairs and dtypes; Kerr,
Kerr-Newman at a = 0 and Johannsen-Psaltis; with and without the time
component) bitwise the plain loop on the card on 1,024 of chip_smoke.py
phase 27's rays, on its own launch counter; a metric class, dtype or
pair it has no instance of raising before a launch; and each lens-map
mode of phase 27 at 64^2 on the card against the CPU by its gates
(p27_check). The Kerr kernel with run-time parameters (dynamic_params,
chip_smoke.py phase 28): the theta and mu instances with (M, a) and (M,
a, r_obs) bitwise the plain loop on the card on 1,024 of phase 8's rays,
each on its dynamic_ counter; the hybrid over them on 65,536 rays of the
1024^2 flyby frame bitwise the same driver over the plain loop; float64
raising before a launch; and each mode of phase 28 (the pan, spin and
flyby frames, a lensed flyby frame, the panoramas, the star and its pulse
profile) at 64^2 on the card against the CPU by its gates (p28_check).
The render server (serve.py): a /render on a handler thread bitwise the
same render on the main thread, /healthz naming the card; device_memory()
keyed by card; the chunked trace with the live bar and a chunk store (a
host sync a chunk) bitwise the trace without them.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from light_path_tracer_tpu_torch import (camera, disk, pipeline,
                                         polarization, volumetric)
from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman,
                                                ReissnerNordstrom,
                                                Schwarzschild)
from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
    trace_disk_rays_cuda, trace_disk_rays_plain, trace_disk_rays_two_pass,
    trace_rays_aux_two_pass, trace_rays_kerr_cuda, trace_rays_kerr_plain,
    trace_rays_kerr_two_pass, trace_rays_spectral_two_pass,
    trace_rays_volumetric_two_pass)
from light_path_tracer_tpu_torch.ops import kerr_trace
from light_path_tracer_tpu_torch.ops.cuda import peak_probe
from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
from light_path_tracer_tpu_torch.ops.cuda.schwarzschild_kernel import (
    trace_rays_schwarzschild_cuda, trace_rays_schwarzschild_plain)
from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                      SceneConfig)

pytestmark = pytest.mark.cuda

R_OBS = 100.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rays(n, device):
    m = Kerr(M=1.0, a=0.9)
    ac = m.alpha_crit(R_OBS)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    return (m, ac, torch.tensor(rng.uniform(0.3 * ac, 4 * ac, n), **f32),
            torch.tensor(rng.uniform(-np.pi, np.pi, n), **f32),
            torch.tensor(rng.random(n) < 0.2, device=device))


def test_kernel_matches_plain_version(cuda):
    m, ac, al, th, ref = _rays(2048, cuda)
    before = trace_rays_kerr_cuda.launches
    rk = trace_rays_kerr_cuda(m, R_OBS, al, th, np.pi / 2, ref, 5000.0,
                              20000)
    torch.cuda.synchronize()
    assert trace_rays_kerr_cuda.launches == before + 1
    rp = trace_rays_kerr_plain(m, R_OBS, al, th, np.pi / 2, ref, 5000.0,
                               20000)
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    assert (sk == sp).mean() > 0.99
    a = al.cpu().numpy()
    stable = (sk == 1) & (sp == 1) & (np.abs(a - ac) > 0.05 * ac)
    d = np.abs(rk.final_alpha.cpu().numpy()[stable]
               - rp.final_alpha.cpu().numpy()[stable])
    assert stable.sum() > 1000 and np.percentile(d, 99) < 2e-3
    assert int(rk.n_steps) > 0 and rk.final_alpha.device == al.device


def test_kernel_rejects_bad_inputs(cuda):
    m, _ac, al, th, ref = _rays(64, cuda)
    with pytest.raises(ValueError):
        trace_rays_kerr_cuda(m, R_OBS, al.half(), th.half(), np.pi / 2,
                             ref, 5000.0, 100)
    with pytest.raises(ValueError):
        trace_rays_kerr_cuda(m, R_OBS, al.double(), th, np.pi / 2, ref,
                             5000.0, 100)
    with pytest.raises(ValueError):
        trace_rays_kerr_cuda(m, R_OBS, al[::2], th[::2], np.pi / 2,
                             ref[::2], 5000.0, 100)
    with pytest.raises(ValueError):
        trace_rays_kerr_cuda(m, R_OBS, al, th, np.pi / 2, ref.float(),
                             5000.0, 100)


def test_render_shadow_on_card_matches_cpu(cuda):
    scene = SceneConfig(M=1.0, a=0.9, vertical_fov_deg=12.0)
    img_gpu, st_gpu = pipeline.render_shadow(scene, (64, 64),
                                             RenderConfig(), device=cuda)
    img_cpu, st_cpu = pipeline.render_shadow(scene, (64, 64),
                                             RenderConfig(), device="cpu")
    assert img_gpu.device.type == "cuda"
    assert st_gpu["traced_rays"] == st_cpu["traced_rays"] == 32 * 64
    agree = (img_gpu.cpu() == img_cpu).float().mean().item()
    assert agree >= 0.99


@pytest.mark.parametrize("metric", [Schwarzschild(M=1.0),
                                    ReissnerNordstrom(M=1.0, Q=0.6)],
                         ids=["schwarzschild", "rn_q0.6"])
def test_orbit_kernel_matches_plain_version(cuda, metric):
    ac = metric.alpha_crit(R_OBS)
    rng = np.random.default_rng(1)
    al = torch.tensor(np.concatenate([[0.0], rng.uniform(0.2 * ac, 4 * ac,
                                                         4096)]),
                      dtype=torch.float32, device=cuda)
    before = trace_rays_schwarzschild_cuda.launches
    rk, steps = trace_rays_schwarzschild_cuda(metric, R_OBS, al,
                                              return_steps=True)
    torch.cuda.synchronize()
    assert trace_rays_schwarzschild_cuda.launches == before + 1
    rp, psteps = trace_rays_schwarzschild_plain(metric, R_OBS, al,
                                                return_steps=True)
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    assert (sk == sp).mean() > 0.999 and sk[0] == 0
    a = al.cpu().numpy()
    stable = (sk == 1) & (sp == 1) & (np.abs(a - ac) > 0.05 * ac)
    d = np.abs(rk.final_alpha.cpu().numpy()[stable]
               - rp.final_alpha.cpu().numpy()[stable])
    assert stable.sum() > 3000 and np.percentile(d, 99) < 1e-4
    # The kernel sums each warp's largest per-ray step count itself.
    ks = steps.cpu().to(torch.int64)
    ks = torch.nn.functional.pad(ks, (0, -ks.numel() % 32))
    assert int(rk.n_steps) == int(ks.view(-1, 32).amax(1).sum()) > 0
    assert int(steps[0]) == 0 and int(psteps[0]) == 0


def test_orbit_kernel_rejects_bad_inputs(cuda):
    m = Schwarzschild(M=1.0)
    al = torch.linspace(0.01, 0.2, 64, device=cuda)
    with pytest.raises(ValueError):
        trace_rays_schwarzschild_cuda(m, R_OBS, al.half())
    with pytest.raises(ValueError):
        trace_rays_schwarzschild_cuda(m, R_OBS, al[::2])
    with pytest.raises(ValueError):
        trace_rays_schwarzschild_cuda(m, R_OBS, al.view(8, 8))
    with pytest.raises(TypeError):
        trace_rays_schwarzschild_cuda(Kerr(M=1.0, a=0.9), R_OBS, al)


def test_render_scene_on_card_matches_cpu(cuda):
    scene = SceneConfig(M=1.0, vertical_fov_deg=12.0)
    cfg = RenderConfig(sampling="bilinear")
    src = np.random.default_rng(5).random((64, 64, 3)).astype(np.float32)
    launches = trace_rays_schwarzschild_cuda.launches
    og = pipeline.render_scene(scene, src, cfg, device=cuda)
    oc = pipeline.render_scene(scene, src, cfg, device="cpu")
    assert trace_rays_schwarzschild_cuda.launches == launches + 1
    assert og.image.device.type == "cuda" and og.image.shape == (64, 64, 3)
    mg = torch.isnan(og.precompute.final_alpha).cpu()
    mc = torch.isnan(oc.precompute.final_alpha)
    assert (mg == mc).float().mean().item() >= 0.99
    calm = ((og.precompute.winding.cpu().to(torch.int32) < 2)
            & (oc.precompute.winding.to(torch.int32) < 2))
    diff = (og.image.cpu() - oc.image)[calm]
    assert float((diff ** 2).mean().sqrt()) < 1e-3


THETA_DISK = float(np.radians(80.0))


def _plane(opaque):
    return (disk.r_isco(1.0, 0.9), 20.0, float(np.pi / 2), opaque)


def _bits(x):
    if not x.is_floating_point():
        return x
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("opaque,momentum", [(True, False), (False, True)])
def test_disk_kernel_matches_plain_version(cuda, opaque, momentum):
    m = Kerr(M=1.0, a=0.9)
    # chip_smoke.py phase 8's 4,096 rays: the p99 gate needs the tail of
    # a population this size (a 2,048-ray draw measured p99 0.102 M).
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=cuda)
    al = torch.tensor(rng.uniform(0.01, 0.12, 4096), **f32)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
    args = (m, R_OBS, al, th, THETA_DISK, 5000.0, 20000, _plane(opaque), 2)
    before = trace_disk_rays_cuda.launches
    rk = trace_disk_rays_cuda(*args, record_momentum=momentum)
    torch.cuda.synchronize()
    assert trace_disk_rays_cuda.launches == before + 1
    rp = trace_disk_rays_plain(*args, record_momentum=momentum)
    assert len(rk.pr_hits) == (2 if momentum else 0)
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    nk, npl = rk.n_hits.cpu().numpy(), rp.n_hits.cpu().numpy()
    assert (sk == sp).mean() > 0.99 and (nk == npl).mean() > 0.99
    both = (nk > 0) & (npl > 0)
    d = np.abs(rk.r_hits[0].cpu().numpy()[both]
               - rp.r_hits[0].cpu().numpy()[both])
    assert both.sum() > 2000
    assert np.median(d) < 1e-3 and np.percentile(d, 99) < 0.1
    fk, fp = rk.final_alpha.cpu().numpy(), rp.final_alpha.cpu().numpy()
    free = (nk == 0) & (npl == 0) & np.isfinite(fk) & np.isfinite(fp)
    assert free.sum() > 100
    assert np.median(np.abs(fk[free] - fp[free])) < 1e-4
    if not opaque:
        assert (nk >= 2).sum() > 50


def test_disk_kernel_rejects_bad_inputs(cuda):
    m = Kerr(M=1.0, a=0.9)
    al = torch.linspace(0.01, 0.1, 64, device=cuda)
    args = (m, R_OBS, al, al, THETA_DISK, 5000.0, 100, _plane(True))
    with pytest.raises(ValueError):
        trace_disk_rays_cuda(*args, 0)
    with pytest.raises(ValueError):
        trace_disk_rays_cuda(m, R_OBS, al.half(), al.half(), *args[4:], 2)
    with pytest.raises(ValueError):
        trace_disk_rays_cuda(m, R_OBS, al.double(), al, *args[4:], 2)


def test_disk_two_pass_equals_single_pass_on_card(cuda):
    m = Kerr(M=1.0, a=0.9)
    dim = (256, 256)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    grid = dict(dtype=torch.float32, device=cuda)
    al = camera.build_alpha_lookup(dim, fov, **grid).reshape(-1)
    th = camera.build_theta_lookup(dim, fov, **grid).reshape(-1)
    args = (m, R_OBS, al, th, THETA_DISK, 5000.0, 20000, _plane(False), 2)
    one = trace_disk_rays_cuda(*args, record_momentum=True)
    two = trace_disk_rays_two_pass(*args, pass1_steps=64,
                                   record_momentum=True)
    _, unconv = trace_disk_rays_cuda(*args[:6], 64, _plane(False), 2,
                                     return_unconverged=True)
    assert 0 < int(unconv.sum()) <= 8192
    for a, b in zip([one.status, one.n_hits, one.final_alpha, *one.r_hits,
                     *one.phi_hits, *one.pr_hits, *one.pth_hits],
                    [two.status, two.n_hits, two.final_alpha, *two.r_hits,
                     *two.phi_hits, *two.pr_hits, *two.pth_hits]):
        assert torch.equal(_bits(a), _bits(b))


def test_kerr_two_pass_equals_single_pass_on_card(cuda):
    scene = SceneConfig(M=1.0, a=0.9)
    cfg = RenderConfig()
    dim = (256, 256)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, ref, _rows = pipeline.trace_inputs(scene, cfg, dim, fov, cuda)
    m = Kerr(M=1.0, a=0.9)
    args = (m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 200000)
    one = trace_rays_kerr_cuda(*args)
    two = trace_rays_kerr_two_pass(*args, pass1_steps=64)
    _, unconv = trace_rays_kerr_cuda(*args[:7], 64, return_unconverged=True)
    assert 0 < int(unconv.sum()) <= 8192
    for a, b in zip(one[:3], two[:3]):
        assert torch.equal(_bits(a), _bits(b))
    assert int(two.n_steps) > int(one.n_steps)


def test_render_disk_on_card_matches_cpu(cuda):
    scene = SceneConfig(M=1.0, a=0.9, theta_obs=THETA_DISK)
    before = trace_disk_rays_two_pass.launches
    img_gpu, st_gpu = disk.render_disk(scene, (64, 64), RenderConfig(),
                                       device=cuda)
    img_cpu, st_cpu = disk.render_disk(scene, (64, 64), RenderConfig(),
                                       device="cpu")
    assert trace_disk_rays_two_pass.launches == before + 2
    assert img_gpu.device.type == "cuda" and img_gpu.shape == (64, 64)
    mg, mc = img_gpu.cpu() > 0, img_cpu > 0
    assert (mg == mc).float().mean().item() >= 0.99
    assert st_gpu["disk_pixels"] > 100 and st_gpu["captured"] > 0
    both = mg & mc
    assert float((img_gpu.cpu() - img_cpu).abs()[both].median()) < 1e-3


VOLUMETRIC_FORMS = {
    "thin": (dict(), None),
    "absorbed": (dict(alpha0=0.5), None),
    "jet": (dict(profile="jet", jet_beta=0.6, index=-1.0), None),
    "spectral": (dict(g_power=4.0, alpha0=1.0, opacity_index=2.0),
                 (0.5, 2.0)),
    "spectral 3-band": (dict(g_power=4.0, alpha0=1.0, opacity_index=3.0),
                        (0.1, 1.0, 10.0)),
}


def _extras_rays(n, device, lo=0.3, hi=4.0, seed=0, metric=None):
    m = metric or Kerr(M=1.0, a=0.9)
    ac = m.alpha_crit(R_OBS, THETA_DISK)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    return (m, torch.tensor(rng.uniform(lo * ac, hi * ac, n), **f32),
            torch.tensor(rng.uniform(-np.pi, np.pi, n), **f32))


def _extras_trace(form, kernel, m, al, th, max_steps, **kw):
    """(result, [extras...]) of one form through the kernel wrapper or
    its plain loop."""
    riaf_kw, freqs = VOLUMETRIC_FORMS[form]
    riaf = volumetric.RIAFConfig(**riaf_kw)
    args = (m, R_OBS, al, th, THETA_DISK)
    if freqs:
        tf = volumetric.make_spectral_transfer(m, riaf, freqs)
        fn = (vk.trace_rays_spectral_cuda if kernel
              else kerr_trace.trace_rays_spectral)
        res = fn(*args, tf, len(freqs), 5000.0, max_steps, **kw)
        return res, [res.tau_hat, *res.emission]
    em, ab = volumetric.make_transfer_fns(m, riaf)
    fn = (vk.trace_rays_volumetric_cuda if kernel
          else kerr_trace.trace_rays_volumetric)
    res = fn(*args, em, 5000.0, max_steps, absorption_fn=ab, **kw)
    return res, [res.emission, res.optical_depth]


@pytest.mark.parametrize("form", list(VOLUMETRIC_FORMS))
def test_extras_kernel_matches_plain_version(cuda, form):
    m, al, th = _extras_rays(2048, cuda)
    spectral = form.startswith("spectral")
    launches = (vk.trace_rays_aux_cuda if spectral
                else vk.trace_rays_volumetric_cuda)
    before = launches.launches
    rk, xk = _extras_trace(form, True, m, al, th, 4000, sat_window=2048)
    torch.cuda.synchronize()
    assert launches.launches == before + 1
    rp, xp = _extras_trace(form, False, m, al, th, 4000, sat_window=2048)
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    ok = sk == sp
    assert ok.mean() > 0.99
    for i, (a, b) in enumerate(zip(xk, xp)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        d = np.abs(a - b)[ok]
        if not spectral and i == 1:                # tau
            assert np.percentile(d, 99) < 1e-3
        else:
            assert np.percentile(d, 99) < 1e-3 * max(np.abs(b).max(), 1.0)
    assert int(rk.n_steps) > 0 and rk.status.device == al.device


def test_extras_kernel_rejects_bad_inputs(cuda):
    m, al, th = _extras_rays(64, cuda)
    em, _ = volumetric.make_transfer_fns(m, volumetric.RIAFConfig())
    with pytest.raises(ValueError):
        vk.trace_rays_volumetric_cuda(m, R_OBS, al.half(), th.half(),
                                      THETA_DISK, em, 5000.0, 100)
    with pytest.raises(ValueError):
        vk.trace_rays_volumetric_cuda(m, R_OBS, al.double(), th,
                                      THETA_DISK, em, 5000.0, 100)
    with pytest.raises(ValueError):
        vk.trace_rays_volumetric_cuda(m, R_OBS, al[::2], th[::2],
                                      THETA_DISK, em, 5000.0, 100)
    with pytest.raises(NotImplementedError):
        vk.trace_rays_volumetric_cuda(m, R_OBS, al, th, THETA_DISK,
                                      lambda y, pt, pp: y[0], 5000.0, 100)
    tf = volumetric.make_spectral_transfer(m, volumetric.RIAFConfig(),
                                           tuple(range(1, 10)))
    with pytest.raises(NotImplementedError):
        vk.trace_rays_spectral_cuda(m, R_OBS, al, th, THETA_DISK, tf, 9,
                                    5000.0, 100)
    with pytest.raises(ValueError, match="aux"):
        vk.trace_rays_aux_cuda(m, R_OBS, al, th, THETA_DISK, tf, 10, (al,),
                               5000.0, 100)


@pytest.mark.parametrize("form", ["absorbed", "spectral"])
def test_extras_two_pass_equals_single_pass_on_card(cuda, form):
    m, al, th = _extras_rays(4096, cuda, 0.9, 1.1, seed=9)
    one, xo = _extras_trace(form, True, m, al, th, 20000)
    if form == "spectral":
        riaf_kw, freqs = VOLUMETRIC_FORMS[form]
        tf = volumetric.make_spectral_transfer(
            m, volumetric.RIAFConfig(**riaf_kw), freqs)
        two = trace_rays_spectral_two_pass(
            m, R_OBS, al, th, THETA_DISK, tf, 2, 5000.0, 20000,
            pass1_steps=64)
        xt = [two.tau_hat, *two.emission]
    else:
        em, ab = volumetric.make_transfer_fns(
            m, volumetric.RIAFConfig(alpha0=0.5))
        two = trace_rays_volumetric_two_pass(
            m, R_OBS, al, th, THETA_DISK, em, 5000.0, 20000,
            absorption_fn=ab, pass1_steps=64)
        xt = [two.emission, two.optical_depth]
    for a, b in zip([one.status, one.final_alpha, *xo],
                    [two.status, two.final_alpha, *xt]):
        assert torch.equal(_bits(a), _bits(b))
    assert int(two.n_steps) > int(one.n_steps)


def test_render_volumetric_on_card_matches_cpu(cuda):
    scene = SceneConfig(M=1.0, a=0.9, theta_obs=THETA_DISK,
                        vertical_fov_deg=16.0)
    before = vk.trace_rays_volumetric_cuda.launches
    img_gpu, st_gpu = volumetric.render_volumetric(scene, (64, 64),
                                                   RenderConfig(),
                                                   device=cuda)
    img_cpu, st_cpu = volumetric.render_volumetric(scene, (64, 64),
                                                   RenderConfig(),
                                                   device="cpu")
    assert vk.trace_rays_volumetric_cuda.launches == before + 2
    assert img_gpu.device.type == "cuda" and img_gpu.shape == (64, 64)
    mg, mc = st_gpu["emission"] > 0, st_cpu["emission"] > 0
    assert (mg == mc).mean() >= 0.99
    assert float((img_gpu.cpu() - img_cpu).abs().median()) < 1e-4



def test_render_volumetric_spectrum_on_card_matches_cpu(cuda):
    scene = SceneConfig(M=1.0, a=0.9, theta_obs=THETA_DISK,
                        vertical_fov_deg=16.0)
    riaf = volumetric.RIAFConfig(g_power=4.0, alpha0=1.0, opacity_index=3.0)
    freqs = (0.1, 1.0, 10.0)
    before = vk.trace_rays_aux_cuda.launches
    img_gpu, st_gpu = volumetric.render_volumetric_spectrum(
        scene, (64, 64), freqs, RenderConfig(), riaf, device=cuda)
    img_cpu, st_cpu = volumetric.render_volumetric_spectrum(
        scene, (64, 64), freqs, RenderConfig(), riaf, device="cpu")
    assert vk.trace_rays_aux_cuda.launches == before + 2
    assert img_gpu.device.type == "cuda" and img_gpu.shape == (3, 64, 64)
    for band in range(3):
        mg = st_gpu["emission"][band] > 0
        mc = st_cpu["emission"][band] > 0
        assert (mg == mc).mean() >= 0.99
        assert float((img_gpu[band].cpu() - img_cpu[band]).abs()
                     .median()) < 1e-4


def _assert_orders_agree(bk, bp):
    """Order buckets bk against bp, each (orders, rays). floor(m) flips a
    coin per ray and crossing (m sits within rounding of an integer), so
    single rays differ; every order is held on its own, with bars that
    follow 1 / sqrt(rays that carry it): its flux within max(3 %, 3 /
    sqrt(carriers)), more than 40 % of its carriers (bucket above 5 % of
    the ray's sum) with the same value within 1 % of that sum, at most
    max(1 %, 1 / sqrt(carriers of order 0)) of the total flux moved,
    and the buckets' sum per ray within 1e-3 of the largest (p99)."""
    sk, sp = bk.sum(axis=0), bp.sum(axis=0)
    fk, fp = bk.sum(axis=1), bp.sum(axis=1)
    assert np.percentile(np.abs(sk - sp), 99) < 1e-3 * sp.max()
    carry = (sp > 1e-3 * sp.max()) & (bp > 0.05 * sp)
    carriers = carry.sum(axis=1)
    assert carriers.min() >= 20
    near = (np.abs(bk - bp) < 0.01 * sp) & carry
    assert (near.sum(axis=1) / carriers).min() > 0.4
    assert np.all(np.abs(fk - fp) / fp
                  < np.maximum(0.03, 3.0 / np.sqrt(carriers)))
    assert (np.abs(fk - fp).max() / fp.sum()
            < max(0.01, 1.0 / np.sqrt(carriers[0])))


def _aux_forms(m, al, th):
    """label -> (transfer_fn, n_extras, aux, sat_monitor) of the Stokes,
    movie and order forms."""
    period = 2.0 * np.pi / abs(disk.keplerian_omega(1.0, 0.9, 6.0, True))
    times = tuple(period * k / 8 for k in range(8))
    forms = {}
    for a0 in (0.0, 0.3):
        riaf = volumetric.RIAFConfig(spot_amp=8.0, alpha0=a0)
        ab = int(a0 > 0)
        forms[f"movie8 alpha0={a0}"] = (
            volumetric.make_movie_transfer(m, riaf, times), 9 + ab, (),
            tuple(range(1 + ab, 9 + ab)))
        forms[f"order3 alpha0={a0}"] = (
            volumetric.make_order_transfer(m, riaf, 3), 4 + ab, (),
            tuple(range(1 + ab, 4 + ab)))
    # Two orders: the open-ended last bucket takes every later crossing.
    forms["order2 alpha0=0.0"] = (
        volumetric.make_order_transfer(m, volumetric.RIAFConfig(), 2), 3,
        (), (1, 2))
    aux = polarization.camera_constants(m, R_OBS, THETA_DISK, al, th)
    for field in ("vertical", "toroidal", "radial"):
        forms[f"stokes {field}"] = (
            polarization.make_polarized_volumetric_transfer(
                m, volumetric.RIAFConfig(), field, 0.7), 3, aux, (0, 1, 2))
    return forms


AUX_FORMS = ["movie8 alpha0=0.0", "movie8 alpha0=0.3", "order3 alpha0=0.0",
             "order3 alpha0=0.3", "order2 alpha0=0.0", "stokes vertical",
             "stokes toroidal", "stokes radial"]


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("field", ["vertical", "toroidal", "radial"])
def test_stokes_kernel_bitwise_plain_loop(cuda, field, dtype, method):
    """The Stokes kernel sums the Levi-Civita contraction in the plain
    loop's order, so each instance (both pairs and dtypes) equals its
    plain loop on the card bit for bit: status, final alpha and the
    (I, Q, U) path integrals."""
    m, al, th = _extras_rays(1024, cuda)
    tf, n_extras, aux, monitor = _aux_forms(m, al, th)[f"stokes {field}"]
    al, th = al.to(dtype), th.to(dtype)
    aux = tuple(a.to(dtype) for a in aux)
    kw = dict(sat_window=512, sat_monitor=monitor, method=method)
    rk = vk.trace_rays_aux_cuda(m, R_OBS, al, th, THETA_DISK, tf, n_extras,
                                aux, 5000.0, 1000, **kw)
    rp = kerr_trace.trace_rays_aux(m, R_OBS, al, th, THETA_DISK, tf,
                                   n_extras, aux, 5000.0, 1000, **kw)
    for x, y in zip((rk.status, rk.final_alpha.nan_to_num(9.0),
                     *rk.extras), (rp.status, rp.final_alpha.nan_to_num(9.0),
                                   *rp.extras)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("form", AUX_FORMS)
def test_aux_kernel_matches_plain_version(cuda, form):
    m, al, th = _extras_rays(2048, cuda)
    tf, n_extras, aux, monitor = _aux_forms(m, al, th)[form]
    kw = dict(sat_window=2048, sat_monitor=monitor)
    before = vk.trace_rays_aux_cuda.launches
    plain_before = kerr_trace.trace_rays_aux.launches
    rk = vk.trace_rays_aux_cuda(m, R_OBS, al, th, THETA_DISK, tf, n_extras,
                                aux, 5000.0, 4000, **kw)
    torch.cuda.synchronize()
    assert vk.trace_rays_aux_cuda.launches == before + 1
    assert kerr_trace.trace_rays_aux.launches == plain_before
    extra = tf if aux else (lambda y, pt, pp, _aux: tf(y, pt, pp))
    rp = kerr_trace.trace_rays_aux(m, R_OBS, al, th, THETA_DISK, extra,
                                   n_extras, aux, 5000.0, 4000, **kw)
    ok = (rk.status == rp.status).cpu().numpy()
    assert ok.mean() > 0.99
    xk = np.stack([e.cpu().numpy() for e in rk.extras]).astype(np.float64)
    xp = np.stack([e.cpu().numpy() for e in rp.extras]).astype(np.float64)
    if form.startswith("order"):
        first = len(monitor)
        _assert_orders_agree(xk[-first:][:, ok], xp[-first:][:, ok])
        assert np.percentile(np.abs(xk[0] - xp[0])[ok], 95) < 2e-3
        return
    scale = np.abs(xp[0]).max() if form.startswith("stokes") else None
    for a, b in zip(xk, xp):
        bar = 1e-3 * (scale or max(np.abs(b).max(), 1.0))
        assert np.percentile(np.abs(a - b)[ok], 99) < bar


def test_aux_kernel_rejects_bad_inputs(cuda):
    m, al, th = _extras_rays(64, cuda)
    forms = _aux_forms(m, al, th)
    tf, n_extras, aux, _mon = forms["stokes toroidal"]
    args = (m, R_OBS, al, th, THETA_DISK, tf, n_extras)
    with pytest.raises(ValueError, match="aux"):
        vk.trace_rays_aux_cuda(*args, aux[:3], 5000.0, 100)
    with pytest.raises(ValueError):
        vk.trace_rays_aux_cuda(*args, (aux[0].double(), *aux[1:]), 5000.0,
                               100)
    with pytest.raises(ValueError):
        vk.trace_rays_aux_cuda(*args, (aux[0][:32], *aux[1:]), 5000.0, 100)
    with pytest.raises(ValueError):
        vk.trace_rays_aux_cuda(*args, (aux[0].cpu(), *aux[1:]), 5000.0, 100)
    with pytest.raises(ValueError):
        vk.trace_rays_aux_cuda(*args, aux, 5000.0, 100, sat_window=8,
                               sat_monitor=(3,))
    nine = volumetric.make_movie_transfer(m, volumetric.RIAFConfig(),
                                          tuple(range(9)))
    with pytest.raises(NotImplementedError):
        vk.trace_rays_aux_cuda(m, R_OBS, al, th, THETA_DISK, nine, 10, (),
                               5000.0, 100)
    five = volumetric.make_order_transfer(m, volumetric.RIAFConfig(), 5)
    with pytest.raises(NotImplementedError):
        vk.trace_rays_aux_cuda(m, R_OBS, al, th, THETA_DISK, five, 6, (),
                               5000.0, 100)
    with pytest.raises(NotImplementedError):
        vk.trace_rays_aux_cuda(m, R_OBS, al, th, THETA_DISK,
                               lambda y, pt, pp, a: (y[0],) * 3, 3, aux,
                               5000.0, 100)


def test_aux_two_pass_equals_single_pass_on_card(cuda):
    m, al, th = _extras_rays(4096, cuda, 0.9, 1.1, seed=9)
    tf, n_extras, aux, monitor = _aux_forms(m, al, th)["stokes toroidal"]
    args = (m, R_OBS, al, th, THETA_DISK, tf, n_extras, aux, 5000.0, 20000)
    one = vk.trace_rays_aux_cuda(*args)
    _, unconv = vk.trace_rays_aux_cuda(*args[:9], 64,
                                       return_unconverged=True)
    assert 0 < int(unconv.sum()) <= 1024
    two = trace_rays_aux_two_pass(*args, pass1_steps=64)
    for a, b in zip([one.status, one.final_alpha, *one.extras],
                    [two.status, two.final_alpha, *two.extras]):
        assert torch.equal(_bits(a), _bits(b))
    assert int(two.n_steps) > int(one.n_steps)


@pytest.mark.parametrize("form", list(peak_probe.FORMS))
def test_peak_probe_matches_torch_loop(cuda, form):
    _index, dtype, _ops = peak_probe.FORMS[form]
    k = 64
    x = torch.linspace(0.1, 0.9, 4097, dtype=dtype, device=cuda)
    before = peak_probe.chain_cuda.launches
    got = peak_probe.chain_cuda(x, k, form)
    torch.cuda.synchronize()
    assert peak_probe.chain_cuda.launches == before + 1
    want = peak_probe.chain_plain(x, k, form)
    ulp = torch.finfo(dtype).eps
    bar = 4 * ulp if form == "sin" else 4 * k * ulp * float(want.abs().max())
    assert float((got - want).abs().max()) <= bar
    assert got.dtype == dtype and got.shape == x.shape
    with pytest.raises(ValueError):
        peak_probe.chain_cuda(x.to(torch.float16), k, form)
    with pytest.raises(ValueError):
        peak_probe.chain_cuda(x[::2], k, form)
    with pytest.raises(ValueError):
        peak_probe.chain_cuda(x, k, "fma16")


def test_peak_probe_rates_are_plausible(cuda):
    rates = peak_probe.measure_rates(cuda, repeats=3)
    assert set(rates) == set(peak_probe.FORMS)
    for row in rates.values():
        assert row["ms_long"] > row["ms_short"] > 0.0
    assert rates["fma32x8"]["rate"] > rates["fma64"]["rate"] > 1e12
    assert rates["sin"]["rate"] > 1e10
    # the library-sequence chains: eight a thread, a call a link
    for form in peak_probe.FORMS:
        if form[:-4] in peak_probe.LIBRARY_FORMS:
            assert np.isfinite(rates[form]["rate"])
            assert rates[form]["rate"] > 1e9


def test_new_renders_on_card_match_cpu(cuda):
    scene = SceneConfig(M=1.0, a=0.9, theta_obs=THETA_DISK,
                        vertical_fov_deg=16.0)
    cfg = RenderConfig()
    size = (64, 64)
    before = vk.trace_rays_aux_cuda.launches
    fg, sg = volumetric.render_volumetric_movie(
        scene, size, (0.0, 30.0, 60.0), cfg,
        volumetric.RIAFConfig(spot_amp=8.0), device=cuda)
    fc, sc = volumetric.render_volumetric_movie(
        scene, size, (0.0, 30.0, 60.0), cfg,
        volumetric.RIAFConfig(spot_amp=8.0), device="cpu")
    assert fg.device.type == "cuda" and fg.shape == (3, 64, 64)
    assert float((fg.cpu() - fc).abs().median()) < 1e-4
    np.testing.assert_allclose(sg["light_curve"], sc["light_curve"],
                               rtol=1e-3)
    lg, _tg = volumetric.render_volumetric_decomposed(scene, size, cfg,
                                                      device=cuda)
    lc, _tc = volumetric.render_volumetric_decomposed(scene, size, cfg,
                                                      device="cpu")
    _assert_orders_agree(
        lg.cpu().numpy().astype(np.float64).reshape(3, -1),
        lc.numpy().astype(np.float64).reshape(3, -1))
    _e, pg, ig, stg = polarization.render_polarized_volumetric(
        scene, size, cfg, device=cuda)
    _e, pc, ic, stc = polarization.render_polarized_volumetric(
        scene, size, cfg, device="cpu")
    assert vk.trace_rays_aux_cuda.launches == before + 6
    peak = ic.max()
    for key in "IQU":
        assert np.median(np.abs(stg[key] - stc[key])) < 1e-5 * peak
    bright = ic > 1e-3 * peak
    assert pg[bright].max() <= 0.7 + 1e-5
    assert np.median(np.abs(pg - pc)[bright]) < 1e-3


def _width_form(family, width, m, al, th):
    """(transfer_fn, n_extras, aux, sat_monitor) of one instance of the
    extras kernel: family thin, absorbed, stokes, spectral (width bands),
    movie thin or absorbed (width frames), order thin or absorbed (width
    orders)."""
    R = volumetric.RIAFConfig
    if family in ("thin", "absorbed"):
        em, ab = volumetric.make_transfer_fns(
            m, R(alpha0=0.5 if family == "absorbed" else 0.0))
        return (em, ab), 1 + (family == "absorbed"), (), (0,)
    if family == "stokes":
        aux = polarization.camera_constants(m, R_OBS, THETA_DISK, al, th)
        return (polarization.make_polarized_volumetric_transfer(
            m, R(), "toroidal", 0.7), 3, aux, (0, 1, 2))
    if family == "spectral":
        freqs = tuple(np.geomspace(0.1, 10.0, width)) if width > 1 else (1.,)
        return (volumetric.make_spectral_transfer(
            m, R(g_power=4.0, alpha0=1.0, opacity_index=2.0), freqs),
            1 + width, (), tuple(range(1, 1 + width)))
    ab = int(family.endswith("absorbed"))
    a0 = 0.3 if ab else 0.0
    if family.startswith("movie"):
        period = 2.0 * np.pi / abs(disk.keplerian_omega(1.0, 0.9, 6.0, True))
        times = tuple(period * k / width for k in range(width))
        tf = volumetric.make_movie_transfer(m, R(spot_amp=8.0, alpha0=a0),
                                            times)
    else:
        tf = volumetric.make_order_transfer(m, R(alpha0=a0), width)
    return tf, 1 + ab + width, (), tuple(range(1 + ab, 1 + ab + width))


WIDTH_CASES = ([("thin", 0), ("absorbed", 0), ("stokes", 0)]
               + [("spectral", b) for b in range(1, 9)]
               + [(f"movie {k}", f) for k in ("thin", "absorbed")
                  for f in range(1, 9)]
               + [(f"order {k}", o) for k in ("thin", "absorbed")
                  for o in range(2, 5)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("family,width", WIDTH_CASES,
                         ids=[f"{f} {w}" for f, w in WIDTH_CASES])
def test_every_extras_instance_matches_plain_version(cuda, family, width,
                                                     dtype):
    """Every instance the families build, in both scalar types, each under
    its own block bound, launched once and held against the plain loop of
    its dtype on the same rays, with
    the gates of the tests above: float32 status agreement above 0.99 and
    each extra's p99 |d| / max below 1e-3 (Stokes Q and U against max
    |I|), float64 at most one status flip and 1e-6; the order buckets by
    flux and carriers. Rays clear of the photon ring (alpha in 1.3..4
    alpha_crit) end within a few hundred attempts, which keeps the plain
    loops short; the orders take phase 11's rays, and four orders the
    band about the critical curve, whose rays carry up to the third
    order: the fourth, which no ray of the band reaches, must stay empty
    in both."""
    _check_extras_instance(cuda, family, width, dtype)


def _check_extras_instance(cuda, family, width, dtype, method="dp45",
                           metric=None):
    """test_every_extras_instance_matches_plain_version's body for one
    instance of the embedded pair `method` (of `metric`'s family, Kerr by
    default)."""
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        counter_name)
    if family.startswith("order"):
        lo, hi = (0.97, 1.06) if width == 4 else (0.3, 4.0)
        m, al, th = _extras_rays(2048, cuda, lo, hi, seed=5, metric=metric)
        max_steps, window = 4000, 2048
    else:
        m, al, th = _extras_rays(1024, cuda, 1.3, 4.0, seed=5, metric=metric)
        max_steps, window = 1500, 512
    al, th = al.to(dtype), th.to(dtype)
    tf, n_extras, aux, monitor = _width_form(family, width, m, al, th)
    aux = tuple(a.to(dtype) for a in aux)
    f64 = dtype == torch.float64
    kw = dict(sat_window=window, method=method)
    name = counter_name(dtype, method)
    if isinstance(tf, tuple):
        counter = vk.trace_rays_volumetric_cuda
        before = getattr(counter, name)
        rk = counter(m, R_OBS, al, th, THETA_DISK, tf[0], 5000.0, max_steps,
                     absorption_fn=tf[1] if n_extras == 2 else None, **kw)
        rp = kerr_trace.trace_rays_volumetric(
            m, R_OBS, al, th, THETA_DISK, tf[0], 5000.0, max_steps,
            absorption_fn=tf[1] if n_extras == 2 else None, **kw)
        xk = [rk.emission, rk.optical_depth][:n_extras]
        xp = [rp.emission, rp.optical_depth][:n_extras]
    else:
        counter = vk.trace_rays_aux_cuda
        before = getattr(counter, name)
        rk = counter(m, R_OBS, al, th, THETA_DISK, tf, n_extras, aux,
                     5000.0, max_steps, sat_monitor=monitor, **kw)
        extra = tf if aux else (lambda y, pt, pp, _aux: tf(y, pt, pp))
        rp = kerr_trace.trace_rays_aux(m, R_OBS, al, th, THETA_DISK, extra,
                                       n_extras, aux, 5000.0, max_steps,
                                       sat_monitor=monitor, **kw)
        xk, xp = list(rk.extras), list(rp.extras)
    torch.cuda.synchronize()
    assert getattr(counter, name) == before + 1
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    ok = sk == sp
    if f64:
        assert (~ok).sum() <= 1
    else:
        assert ok.mean() > 0.99
    xk = np.stack([e.cpu().numpy() for e in xk]).astype(np.float64)
    xp = np.stack([e.cpu().numpy() for e in xp]).astype(np.float64)
    if family.startswith("order"):
        bk, bp = xk[-width:][:, ok], xp[-width:][:, ok]
        if width == 4:
            # No ray of the band carries a fourth order (three plane
            # crossings), so that bucket must stay empty on both sides.
            assert bk[3].sum() <= 1e-3 * bk.sum()
            assert bp[3].sum() <= 1e-3 * bp.sum()
            bk, bp = bk[:3], bp[:3]
        _assert_orders_agree(bk, bp)
        return
    tol = 1e-6 if f64 else 1e-3
    scale = np.abs(xp[0]).max() if family == "stokes" else None
    for i, (a, b) in enumerate(zip(xk, xp)):
        bar = tol * (scale or max(np.abs(b).max(), 1.0))
        if family == "absorbed" and i == 1 and not f64:
            bar = tol                                   # tau, as above
        assert np.percentile(np.abs(a - b)[ok], 99) < bar


def test_every_extras_instance_fits_an_sm(cuda):
    """The runtime's view of every instance: its block bound met (at least
    min_blocks 128-thread blocks an SM, so at most 65,536 / (128
    min_blocks) registers a thread)."""
    for label, entry, form, variant, dtype in vk.extras_instances():
        d = vk.describe_instance(entry, form, variant, dtype)
        assert d["blocks_per_sm"] >= d["min_blocks"] >= 1, (label, d)
        assert 0 < d["registers"] <= 65536 // (128 * d["min_blocks"]), (
            label, d)


F64_FAMILIES = ["kerr", "disk", "orbit schwarzschild", "orbit rn_q0.6",
                "thin", "absorbed", "spectral 3-band", "stokes toroidal",
                "movie8 alpha0=0.0", "movie8 alpha0=0.3", "order3 alpha0=0.0"]


@pytest.mark.parametrize("family", F64_FAMILIES)
def test_float64_instance_matches_plain_float64(cuda, family):
    """Each family's float64 instance against the plain loop in float64 on
    the same rays: both round alike up to FMA contraction and the libm's
    last ulp, so statuses agree (at most one ray of 512 or 2,048 flips at
    an accept/reject tie), p99 |d final_alpha| < 1e-6 rad on stable
    escaped rays (orbit: < 1e-8), extras p99 |d| / max < 1e-6, disk
    median |d r_hits[0]| < 1e-6 M, the order buckets by flux. The
    float64 launch counter grows and the float32 one does not."""
    f64 = dict(dtype=torch.float64, device=cuda)
    if family == "kerr":
        m, ac, al, th, ref = _rays(512, cuda)
        al, th = al.double(), th.double()
        counter = trace_rays_kerr_cuda
        args = (m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 20000)
        before = (counter.launches, counter.launches_f64)
        rk = counter(*args)
        rp = trace_rays_kerr_plain(*args)
    elif family == "disk":
        m = Kerr(M=1.0, a=0.9)
        rng = np.random.default_rng(0)
        al = torch.tensor(rng.uniform(0.01, 0.12, 512), **f64)
        th = torch.tensor(rng.uniform(-np.pi, np.pi, 512), **f64)
        counter = trace_disk_rays_cuda
        args = (m, R_OBS, al, th, THETA_DISK, 5000.0, 20000, _plane(True), 2)
        before = (counter.launches, counter.launches_f64)
        rk = counter(*args)
        rp = trace_disk_rays_plain(*args)
    elif family.startswith("orbit"):
        m = (Schwarzschild(M=1.0) if family.endswith("schwarzschild")
             else ReissnerNordstrom(M=1.0, Q=0.6))
        ac = m.alpha_crit(R_OBS)
        rng = np.random.default_rng(1)
        al = torch.tensor(np.concatenate([[0.0], rng.uniform(
            0.2 * ac, 4 * ac, 1024)]), **f64)
        counter = trace_rays_schwarzschild_cuda
        before = (counter.launches, counter.launches_f64)
        rk = counter(m, R_OBS, al)
        rp = trace_rays_schwarzschild_plain(m, R_OBS, al)
        assert int(rk.status[0]) == 0
    else:
        m, al, th = _extras_rays(2048, cuda)
        al, th = al.double(), th.double()
        if family in VOLUMETRIC_FORMS:
            counter = (vk.trace_rays_aux_cuda if family.startswith("spec")
                       else vk.trace_rays_volumetric_cuda)
            before = (counter.launches, counter.launches_f64)
            rk, xk = _extras_trace(family, True, m, al, th, 4000,
                                   sat_window=2048)
            rp, xp = _extras_trace(family, False, m, al, th, 4000,
                                   sat_window=2048)
        else:
            tf, n_extras, aux, monitor = _aux_forms(m, al, th)[family]
            kw = dict(sat_window=2048, sat_monitor=monitor)
            counter = vk.trace_rays_aux_cuda
            before = (counter.launches, counter.launches_f64)
            rk = counter(m, R_OBS, al, th, THETA_DISK, tf, n_extras, aux,
                         5000.0, 4000, **kw)
            extra = tf if aux else (lambda y, pt, pp, _aux: tf(y, pt, pp))
            rp = kerr_trace.trace_rays_aux(m, R_OBS, al, th, THETA_DISK,
                                           extra, n_extras, aux, 5000.0,
                                           4000, **kw)
            xk, xp = list(rk.extras), list(rp.extras)
    torch.cuda.synchronize()
    assert (counter.launches, counter.launches_f64) == (before[0],
                                                        before[1] + 1)
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    assert (sk != sp).sum() <= 1
    ok = sk == sp
    if family in ("kerr", "disk") or family.startswith("orbit"):
        assert rk.final_alpha.dtype == torch.float64
        fk, fp = rk.final_alpha.cpu().numpy(), rp.final_alpha.cpu().numpy()
        if family == "disk":
            nk, npl = rk.n_hits.cpu().numpy(), rp.n_hits.cpu().numpy()
            assert (nk != npl).sum() <= 1
            both = (nk > 0) & (npl > 0)
            d = np.abs(rk.r_hits[0].cpu().numpy()[both]
                       - rp.r_hits[0].cpu().numpy()[both])
            assert both.sum() > 200 and np.median(d) < 1e-6
            return
        a = al.cpu().numpy()
        stable = (sk == 1) & (sp == 1) & (np.abs(a - ac) > 0.05 * ac)
        d = np.abs(fk[stable] - fp[stable])
        bar = 1e-6 if family == "kerr" else 1e-8
        assert stable.sum() > 200 and np.percentile(d, 99) < bar
        return
    xk = np.stack([e.cpu().numpy() for e in xk])
    xp = np.stack([e.cpu().numpy() for e in xp])
    assert xk.dtype == np.float64
    if family.startswith("order"):
        _assert_orders_agree(xk[-3:][:, ok], xp[-3:][:, ok])
        return
    scale = np.abs(xp[0]).max() if family.startswith("stokes") else None
    for a, b in zip(xk, xp):
        bar = 1e-6 * (scale or max(np.abs(b).max(), 1.0))
        assert np.percentile(np.abs(a - b)[ok], 99) < bar


def _near_axis(dim, fov_deg, cols, device, rows=None):
    """The rays of columns `cols` (and rows `rows`) of a grid."""
    fov = camera.fov_from_vertical(np.radians(fov_deg), dim)
    grid = dict(dtype=torch.float32, device=device)
    al = camera.build_alpha_lookup(dim, fov, **grid)
    th = camera.build_theta_lookup(dim, fov, **grid)
    rows = slice(None) if rows is None else rows
    return (al[rows, cols].reshape(-1).contiguous(),
            th[rows, cols].reshape(-1).contiguous())


def test_cycle_exit_is_bitwise_on_frozen_disk_lanes(cuda):
    """Config 4's near-axis lanes (rows 940-979, columns 500-523 of the
    aligned 1024^2 disk grid, ray (959, 511) among them): the kernel with
    the exact-cycle exit and the same kernel grinding every attempt give
    bitwise the same state, status, hits, per-ray attempts and step
    sum."""
    m = Kerr(M=1.0, a=0.9)
    al, th = _near_axis((1024, 1024), 40.0, slice(500, 524), cuda,
                        slice(940, 980))
    out = {}
    for exit_on in (True, False):
        probe = {}
        r = trace_disk_rays_cuda(m, R_OBS, al, th, THETA_DISK, 5000.0,
                                 200000, _plane(True), 2, probe=probe,
                                 _cycle_exit=exit_on)
        out[exit_on] = (r, probe)
    (a, pa), (b, pb) = out[True], out[False]
    fields = [(a.status, b.status), (a.n_hits, b.n_hits),
              (a.final_alpha, b.final_alpha), (a.n_half, b.n_half),
              (a.n_steps, b.n_steps), (pa["attempts"], pb["attempts"])]
    fields += list(zip(a.r_hits, b.r_hits)) + list(zip(a.phi_hits,
                                                       b.phi_hits))
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in fields)


@pytest.mark.parametrize("form", ["thin", "spectral 3-band",
                                  "order3 alpha0=0.0"])
def test_cycle_exit_is_bitwise_on_frozen_volumetric_lanes(cuda, form):
    """The volumetric scene's near-axis columns 500-523 at 1024^2 (a = 0.9,
    theta_obs 80 deg, FOV 16 deg), where lanes freeze bitwise and the
    frozen-state exit ends them: with the exact-cycle exit and without it
    the extras, status, final alpha, flags, per-ray attempts and warp step
    sum agree bitwise, and some lanes did freeze."""
    m = Kerr(M=1.0, a=0.9)
    al, th = _near_axis((1024, 1024), 16.0, slice(500, 524), cuda)
    out = {}
    for exit_on in (True, False):
        probe = {}
        kw = dict(sat_window=2048, probe=probe, _cycle_exit=exit_on)
        if form in VOLUMETRIC_FORMS:
            r, x = _extras_trace(form, True, m, al, th, 200000, **kw)
        else:
            tf, n_extras, aux, monitor = _aux_forms(m, al, th)[form]
            r = vk.trace_rays_aux_cuda(m, R_OBS, al, th, THETA_DISK, tf,
                                       n_extras, aux, 5000.0, 200000,
                                       sat_monitor=monitor, **kw)
            x = list(r.extras)
        out[exit_on] = (r, x, probe)
    (a, xa, pa), (b, xb, pb) = out[True], out[False]
    fields = [(a.status, b.status), (a.final_alpha, b.final_alpha),
              (a.n_half_orbits, b.n_half_orbits), (a.n_steps, b.n_steps),
              (pa["attempts"], pb["attempts"]), (pa["flags"], pb["flags"])]
    fields += list(zip(xa, xb))
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in fields)
    assert int((pb["flags"] & 6).ne(0).sum()) > 0


# Config 4's row 959 of the aligned 1024^2 grid, pinned to JAX by
# tests/test_torch_config4_ray.py: (column, attempts); each escapes with
# no disk hit.
ROW_959 = [(511, 51), (510, 51), (512, 17)]


@pytest.mark.parametrize("col,attempts", ROW_959)
def test_config4_row_959_ends_as_jax_on_card(cuda, col, attempts):
    """Built without FMA contraction, the disk kernel ends config 4's
    near-axis rays as JAX does (with contraction ray 511 froze in a
    period-1 cycle and counted out the budget)."""
    m = Kerr(M=1.0, a=0.9)
    al, th = _near_axis((1024, 1024), 40.0, slice(col, col + 1), cuda,
                        slice(959, 960))
    probe = {}
    r = trace_disk_rays_cuda(m, R_OBS, al, th, THETA_DISK, 5000.0, 200000,
                             _plane(True), 2, probe=probe)
    assert int(r.status[0]) == 1 and int(r.n_hits[0]) == 0
    assert int(probe["attempts"][0]) == attempts


QUARTER_CAP = 1000


def _card_open(kernel, plain):
    return pytest.mark.xfail(
        reason=f"ROADMAP Queue 3 #1: the card ends this near-axis lane "
               f"{kernel}, the plain loop on the CPU {plain} (status, hits, "
               f"attempts; without contraction the roundings of sinf, cosf "
               f"and powf still differ from the CPU's)")


@pytest.mark.parametrize("row,col", [
    (181, 512),
    pytest.param(233, 512, marks=_card_open((1, 0, 69), (1, 0, 63))),
    pytest.param(447, 512, marks=_card_open((1, 1, 70), (1, 1, 76))),
    (450, 512), (798, 512), (950, 511), (978, 511)])
def test_config4_quarter_offset_lane_ends_as_plain_loop_on_card(cuda, row,
                                                                col):
    """The quarter-offset config-4 grid's seven lanes that froze with FMA
    contraction, capped at QUARTER_CAP attempts: the kernel ends each as
    the plain loop on the CPU does (status, hits, attempts)."""
    m = Kerr(M=1.0, a=0.9)
    fov = camera.fov_from_vertical(np.radians(40.0), (1024, 1024))
    grid = dict(dtype=torch.float32, device=cuda, pixel_offset=(0.25, 0.25))
    i = row * 1024 + col
    al = camera.build_alpha_lookup((1024, 1024), fov, **grid).reshape(-1)
    th = camera.build_theta_lookup((1024, 1024), fov, **grid).reshape(-1)
    al, th = al[i:i + 1].contiguous(), th[i:i + 1].contiguous()
    probe = {}
    rk = trace_disk_rays_cuda(m, R_OBS, al, th, THETA_DISK, 5000.0,
                              QUARTER_CAP, _plane(True), 2, probe=probe)
    rp = trace_disk_rays_plain(m, R_OBS, al.cpu(), th.cpu(), THETA_DISK,
                               5000.0, QUARTER_CAP, _plane(True), 2)
    assert (int(rk.status[0]), int(rk.n_hits[0]),
            int(probe["attempts"][0])) == (int(rp.status[0]),
                                           int(rp.n_hits[0]),
                                           int(rp.n_steps))


@pytest.mark.parametrize("field", [
    "status",
    pytest.param("attempts", marks=pytest.mark.xfail(
        reason="ROADMAP Queue 3 #4, #6: the card captures the lane in 148 "
               "attempts, the plain loop on the CPU in 144 (JAX in 150)"))])
def test_order_lane_ends_as_plain_loop_on_card(cuda, field):
    """The 256^2 order decomposition's lane (171, 129) under Order<3>
    (thin, sat_window 2,048), which the kernel froze while it contracted
    a*b + c: the kernel captures it, as the plain loop on the CPU does."""
    m = Kerr(M=1.0, a=0.9)
    d = (256, 256)
    fov = camera.fov_from_vertical(np.radians(16.0), d)
    grid = dict(dtype=torch.float32, device=cuda)
    i = 171 * 256 + 129
    al = camera.build_alpha_lookup(d, fov, **grid).reshape(-1)[i:i + 1]
    th = camera.build_theta_lookup(d, fov, **grid).reshape(-1)[i:i + 1]
    tf = volumetric.make_order_transfer(m, volumetric.RIAFConfig(), 3)
    probe = {}
    rk = vk.trace_rays_aux_cuda(m, R_OBS, al, th, THETA_DISK, tf, 4, (),
                                5000.0, 200000, sat_window=2048,
                                sat_monitor=(1, 2, 3), probe=probe)
    rp = kerr_trace.trace_rays_aux(
        m, R_OBS, al.cpu(), th.cpu(), THETA_DISK,
        lambda y, p_t, p_phi, _aux: tf(y, p_t, p_phi), 4, (), 5000.0, 6000,
        sat_window=2048, sat_monitor=(1, 2, 3))
    if field == "status":
        assert int(rk.status[0]) == int(rp.status[0]) == -1
    else:
        assert int(probe["attempts"][0]) == int(rp.n_steps)


def _kerr_cases(device):
    """(label, run(dtype, probe, n)) of the Kerr kernel's own checks over
    the first n rays: the main path's rays at 256^2, and config 4's
    near-axis block (rows 940-979, columns 500-523 of the aligned 1024^2
    grid) beside 4,096 random disk rays, opaque with two slots and
    translucent with momenta."""
    m = Kerr(M=1.0, a=0.9)
    scene = SceneConfig(M=1.0, a=0.9)
    cfg = RenderConfig()
    dim = (256, 256)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, ref, _rows = pipeline.trace_inputs(scene, cfg, dim, fov, device)
    ald, thd = _near_axis((1024, 1024), 40.0, slice(500, 524), device,
                          slice(940, 980))
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    ald = torch.cat([ald, torch.tensor(rng.uniform(0.01, 0.12, 4096), **f32)])
    thd = torch.cat([thd, torch.tensor(rng.uniform(-np.pi, np.pi, 4096),
                                       **f32)])

    def shadow(dtype, probe, n=None):
        return trace_rays_kerr_cuda(m, R_OBS, al[:n].to(dtype),
                                    th[:n].to(dtype), np.pi / 2, ref[:n],
                                    5000.0, 200000, return_unconverged=True,
                                    probe=probe)

    def disk_case(opaque, momentum):
        def run(dtype, probe, n=None):
            return trace_disk_rays_cuda(
                m, R_OBS, ald[:n].to(dtype), thd[:n].to(dtype), THETA_DISK,
                5000.0, 200000, _plane(opaque), 2, return_unconverged=True,
                record_momentum=momentum, probe=probe)
        return run
    return {"shadow": shadow, "disk opaque": disk_case(True, False),
            "disk translucent, momenta": disk_case(False, True)}


def _flat(result):
    out = []
    for x in result:
        out.extend(x if isinstance(x, tuple) else (x,))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["shadow", "disk opaque",
                                  "disk translucent, momenta"])
def test_warp_step_sum_and_flags_match_the_probe(cuda, case, dtype):
    """The warp step sum the kernel books (each warp adds its largest
    attempt count) equals the sum over groups of 32 consecutive rays of
    their largest attempt count, also with a short last group; the
    unconverged flags are the rays whose raw status is RUNNING; a call
    without the probe gives bitwise the same outputs (disk: xi is the
    probe's p_phi)."""
    run = _kerr_cases(cuda)[case]
    probe = {}
    res, unconv = run(dtype, probe)
    assert int(res.n_steps) == int(kerr_trace.warp_step_sum(
        probe["attempts"]))
    assert torch.equal(unconv, probe["raw_status"] == kerr_trace.RUNNING)
    again, unconv2 = run(dtype, None)
    for x, y in zip(_flat(res) + [unconv], _flat(again) + [unconv2]):
        assert torch.equal(_bits(x), _bits(y))
    if case != "shadow":
        assert torch.equal(_bits(res.xi), _bits(probe["p_phi"]))
    n = res.status.numel() - 7
    short = {}
    res_n, _unc = run(dtype, short, n)
    assert int(res_n.n_steps) == int(kerr_trace.warp_step_sum(
        short["attempts"]))
    assert torch.equal(short["attempts"], probe["attempts"][:n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_in_kernel_extraction_matches_finalize_angles(cuda, dtype):
    """The kernel's own extraction (finalize, kerr_dp45_common.cuh) against
    the plain loop's finalize_angles on the kernel's raw final states:
    statuses, half-orbits and NaN masks equal, final alpha within a few
    roundings (the two use the same operations in the same order; torch's
    and the kernel's libdevice calls may round apart)."""
    run = _kerr_cases(cuda)["shadow"]
    probe = {}
    res, _unconv = run(dtype, probe)
    p_t = torch.full_like(probe["p_phi"], -1.0)
    fa, nh, st = kerr_trace.finalize_angles(
        Kerr(M=1.0, a=0.9), probe["state"], p_t, probe["p_phi"],
        probe["raw_status"])
    assert torch.equal(st, res.status)
    assert torch.equal(nh, res.n_half_orbits)
    assert torch.equal(torch.isnan(fa), torch.isnan(res.final_alpha))
    ok = torch.isfinite(fa)
    bar = 1e-6 if dtype == torch.float32 else 1e-13
    assert int(ok.sum()) > 1000
    assert float((fa - res.final_alpha)[ok].abs().max()) <= bar


def test_chunked_sorted_and_whole_batch_bitwise_on_card(cuda):
    """The chunked trace_batch, sorted and unsorted, equals the whole
    batch bitwise on 65,536 jittered rays (four AA passes of a 128^2
    grid; chunks of 20,000 rays, padded): the kernel computes each ray
    on its own thread, so neither the chunk nor the lane changes it."""
    from light_path_tracer_tpu_torch import aa
    from light_path_tracer_tpu_torch.ops.batch import trace_batch
    scene, cfg = SceneConfig(M=1.0, a=0.9), RenderConfig()
    m = scene.metric()
    fov = camera.fov_from_vertical(scene.vertical_fov, (128, 128))
    al, th = aa._stacked_grids(m, scene, cfg, (128, 128), fov,
                               aa.aa_offsets(4), device=cuda)
    al, th = al.reshape(-1), th.reshape(-1)
    assert al.numel() == 65536

    def run(**kw):
        return trace_batch(m, R_OBS, al, th, np.pi / 2, two_pass=False,
                           **kw)

    whole = run()
    before = trace_rays_kerr_cuda.launches
    for sort in (True, False):
        got = run(chunk_size=20000, sort_by_difficulty=sort)
        for a, b in zip(got[:3], whole[:3]):
            assert torch.equal(_bits(a), _bits(b))
    assert trace_rays_kerr_cuda.launches == before + 8
    assert (whole.status == 1).any() and (whole.status == -1).any()


def test_adaptive_equals_uniform_aa_on_card(cuda):
    from light_path_tracer_tpu_torch import aa, adaptive
    scene, cfg = SceneConfig(M=1.0, a=0.9), RenderConfig()
    img_u, _ = aa.render_shadow_aa(scene, (256, 256), cfg, aa_samples=4,
                                   device=cuda)
    img_a, st = adaptive.render_shadow_adaptive(
        scene, (256, 256), cfg, aa_samples=4, refine_frac=0.05, device=cuda)
    assert img_a.device.type == "cuda"
    assert st["edge_pixels"] <= st["refined_pixels"]
    assert torch.equal(img_a, img_u)
    assert ((img_u > 0) & (img_u < 1)).any()


def test_aa_on_card_matches_cpu(cuda):
    """The AA entry points at 48x64 on the card against the CPU (both
    capped at 4,096 attempts): shadow images equal on >= 99 % of pixels;
    lensed images (bilinear) RMSE < 1e-3 on pixels whose samples all
    wind < 2 half-orbits on both devices."""
    from light_path_tracer_tpu_torch import aa, adaptive
    scene = SceneConfig(M=1.0, a=0.9)
    cfg = RenderConfig(max_steps=4096)
    cfg_b = RenderConfig(max_steps=4096, sampling="bilinear")
    dim = (48, 64)
    for fn in (aa.render_shadow_aa, adaptive.render_shadow_adaptive):
        og, _ = fn(scene, dim, cfg, device=cuda)
        oc, _ = fn(scene, dim, cfg, device="cpu")
        assert og.device.type == "cuda"
        assert (og.cpu() == oc).float().mean().item() >= 0.99
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    offsets = aa.aa_offsets(4)
    calm = ((aa._trace_all_passes(scene.metric(), scene, cfg_b, dim, fov,
                                  offsets, cuda)[1].cpu().amax(0) < 2)
            & (aa._trace_all_passes(scene.metric(), scene, cfg_b, dim, fov,
                                    offsets, "cpu")[1].amax(0) < 2))
    src = np.random.default_rng(5).random(dim + (3,)).astype(np.float32)
    og, _ = aa.render_scene_aa(scene, src, cfg_b, device=cuda)
    oc, _ = aa.render_scene_aa(scene, src, cfg_b, device="cpu")
    assert calm.float().mean().item() > 0.9
    assert ((og.cpu() - oc)[calm] ** 2).mean().sqrt().item() < 1e-3


FAMILIES = {"kerr_newman": KerrNewman(M=1.0, a=0.6, Q=0.6),
            "johannsen_psaltis": JohannsenPsaltis(M=1.0, a=0.9, eps3=2.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_kernel_matches_plain_version(cuda, family, dtype):
    m = FAMILIES[family]
    ac = 0.06
    rng = np.random.default_rng(21)
    n = 2048 if dtype == torch.float32 else 512
    al = torch.tensor(rng.uniform(0.2 * ac, 4 * ac, n), dtype=dtype,
                      device=cuda)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=dtype,
                      device=cuda)
    ref = torch.tensor(rng.random(n) < 0.2, device=cuda)
    before = (trace_rays_kerr_cuda.launches, trace_rays_kerr_cuda.launches_f64)
    args = (m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 4000)
    rk = trace_rays_kerr_cuda(*args)
    torch.cuda.synchronize()
    after = (trace_rays_kerr_cuda.launches, trace_rays_kerr_cuda.launches_f64)
    f64 = dtype == torch.float64
    assert after[int(f64)] == before[int(f64)] + 1
    rp = trace_rays_kerr_plain(*args)
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    assert (sk == sp).mean() > (0.999 if f64 else 0.99)
    a = al.cpu().numpy()
    ac = m.alpha_crit(R_OBS)
    stable = (sk == 1) & (sp == 1) & (np.abs(a - ac) > 0.05 * ac)
    d = np.abs(rk.final_alpha.cpu().numpy()[stable]
               - rp.final_alpha.cpu().numpy()[stable])
    assert stable.sum() > n // 4
    assert np.percentile(d, 99) < (1e-6 if f64 else 2e-3)
    assert (sk == -1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kerr_newman_disk_kernel_matches_plain_version(cuda, dtype):
    m = FAMILIES["kerr_newman"]
    rng = np.random.default_rng(8)
    n = 2048 if dtype == torch.float32 else 512
    al = torch.tensor(rng.uniform(0.01, 0.12, n), dtype=dtype, device=cuda)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=dtype,
                      device=cuda)
    plane = (disk.r_isco(1.0, 0.6, Q=0.6), 20.0, np.pi / 2, True)
    args = (m, R_OBS, al, th, np.radians(80.0), 5000.0, 4000, plane, 2)
    rk = trace_disk_rays_cuda(*args)
    rp = trace_disk_rays_plain(*args)
    f64 = dtype == torch.float64
    agree = (rk.status == rp.status).double().mean().item()
    hits = (rk.n_hits == rp.n_hits).double().mean().item()
    assert agree > (0.999 if f64 else 0.99) and hits > (0.999 if f64
                                                        else 0.99)
    both = (rk.n_hits > 0) & (rp.n_hits > 0)
    d = (rk.r_hits[0] - rp.r_hits[0]).abs()[both].double()
    assert int(both.sum()) > 50
    assert float(d.median()) < (1e-6 if f64 else 1e-3)
    with pytest.raises(TypeError):
        trace_disk_rays_cuda(FAMILIES["johannsen_psaltis"], *args[1:])


def test_kerr_newman_at_q0_is_the_kerr_kernel(cuda):
    m, _ac, al, th, ref = _rays(4096, cuda)
    args = (R_OBS, al, th, np.pi / 2, ref, 5000.0, 20000)
    pk, pq = {}, {}
    rk = trace_rays_kerr_cuda(m, *args, probe=pk)
    rq = trace_rays_kerr_cuda(KerrNewman(M=1.0, a=0.9, Q=0.0), *args,
                              probe=pq)
    for a, b in list(zip(rk, rq)) + [(pk["state"], pq["state"]),
                                     (pk["attempts"], pq["attempts"])]:
        assert torch.equal(a.nan_to_num(9.0), b.nan_to_num(9.0))


def test_johannsen_psaltis_alpha_crit_on_card_matches_cpu(cuda):
    m = FAMILIES["johannsen_psaltis"]
    kw = dict(n_azimuth=4, iters=10)
    before = trace_rays_kerr_cuda.launches_f64
    on_card = m.alpha_crit(R_OBS, device="cuda", **kw)
    assert trace_rays_kerr_cuda.launches_f64 > before
    assert abs(on_card - m.alpha_crit(R_OBS, device="cpu", **kw)) < 1e-9


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_render_shadow_on_card_matches_cpu(cuda, family,
                                                  monkeypatch):
    m = FAMILIES[family]
    scene = SceneConfig(M=1.0, a=m.a, Q=getattr(m, "Q", 0.0),
                        eps3=getattr(m, "eps3", 0.0), vertical_fov_deg=12.0)
    # The CPU render takes the card's alpha_crit: the full bisection on
    # the CPU plain loop costs ~50 s, and the image does not depend on it.
    ac = m.alpha_crit(R_OBS, np.pi / 2, device="cuda")
    monkeypatch.setattr(type(m), "alpha_crit", lambda self, *a, **k: ac)
    before = trace_rays_kerr_cuda.launches
    plain = kerr_trace.trace_rays_kerr.launches
    og, _ = pipeline.render_shadow(scene, (48, 48), device="cuda")
    assert trace_rays_kerr_cuda.launches > before
    assert kerr_trace.trace_rays_kerr.launches == plain
    oc, _ = pipeline.render_shadow(scene, (48, 48), device="cpu")
    assert (og.cpu() == oc).double().mean().item() >= 0.99
    assert 0 < int((og == 0).sum()) < og.numel()


# ---- DOP853 and linear event location (csrc/kerr_dop853*.cu) -------------

D853_KERR_CASES = [("kerr", "hermite"), ("kerr", "linear"),
                   ("kerr_newman", "hermite"), ("johannsen_psaltis",
                                                "hermite")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("family,event_interp", D853_KERR_CASES,
                         ids=[f"{f} {e}" for f, e in D853_KERR_CASES])
def test_dop853_kernel_matches_plain_version(cuda, family, event_interp,
                                             dtype):
    """The DOP853 instance of each family (and linear event location)
    against the plain DOP853 loop on the same rays, by the DP45 twin's
    gates: float32 status agreement above 0.99 and p99 |d final_alpha|
    < 2e-3 on stable escaped rays, float64 0.999 and 1e-6. Only the
    DOP853 counter of the dtype moves."""
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        counter_name)
    m = Kerr(M=1.0, a=0.9) if family == "kerr" else FAMILIES[family]
    ac = m.alpha_crit(R_OBS) if family != "johannsen_psaltis" else 0.0668
    rng = np.random.default_rng(21)
    f64 = dtype == torch.float64
    n = 512 if f64 else 2048
    kw = dict(dtype=dtype, device=cuda)
    al = torch.tensor(rng.uniform(0.2 * ac, 4 * ac, n), **kw)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, n), **kw)
    ref = torch.tensor(rng.random(n) < 0.2, device=cuda)
    args = (m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 20000)
    d853 = dict(method="dop853", event_interp=event_interp)
    counts = {c: getattr(trace_rays_kerr_cuda, counter_name(t, meth))
              for c, t, meth in (("want", dtype, "dop853"),
                                 ("dp45", dtype, "dp45"))}
    rk = trace_rays_kerr_cuda(*args, **d853)
    torch.cuda.synchronize()
    assert getattr(trace_rays_kerr_cuda,
                   counter_name(dtype, "dop853")) == counts["want"] + 1
    assert getattr(trace_rays_kerr_cuda,
                   counter_name(dtype, "dp45")) == counts["dp45"]
    rp = trace_rays_kerr_plain(*args, **d853)
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    assert (sk == sp).mean() > (0.999 if f64 else 0.99)
    a = al.cpu().numpy()
    stable = (sk == 1) & (sp == 1) & (np.abs(a - ac) > 0.05 * ac)
    d = np.abs(rk.final_alpha.cpu().numpy()[stable]
               - rp.final_alpha.cpu().numpy()[stable])
    assert stable.sum() > n // 4 and (sk == -1).any()
    assert np.percentile(d, 99) < (1e-6 if f64 else 2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("family,momentum", [("kerr", False),
                                             ("kerr", True),
                                             ("kerr_newman", False)])
def test_dop853_disk_kernel_matches_plain_version(cuda, family, momentum,
                                                  dtype):
    """The DOP853 disk variant against the plain DOP853 loop, by the DP45
    disk gates (float64: 0.999 and 1e-6)."""
    if family == "kerr":
        m, plane = Kerr(M=1.0, a=0.9), (disk.r_isco(1.0, 0.9), 20.0,
                                        np.pi / 2, not momentum)
    else:
        m = FAMILIES[family]
        plane = (disk.r_isco(1.0, 0.6, Q=0.6), 20.0, np.pi / 2, True)
    rng = np.random.default_rng(8)
    f64 = dtype == torch.float64
    n = 512 if f64 else 2048
    al = torch.tensor(rng.uniform(0.01, 0.12, n), dtype=dtype, device=cuda)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, n), dtype=dtype,
                      device=cuda)
    args = (m, R_OBS, al, th, np.radians(80.0), 5000.0, 4000, plane, 2)
    kw = dict(method="dop853", record_momentum=momentum)
    rk = trace_disk_rays_cuda(*args, **kw)
    rp = trace_disk_rays_plain(*args, **kw)
    agree = (rk.status == rp.status).double().mean().item()
    hits = (rk.n_hits == rp.n_hits).double().mean().item()
    assert agree > (0.999 if f64 else 0.99) and hits > (0.999 if f64
                                                        else 0.99)
    both = (rk.n_hits > 0) & (rp.n_hits > 0)
    assert int(both.sum()) > 50
    for key in ("r_hits",) + (("pr_hits",) if momentum else ()):
        d = (getattr(rk, key)[0] - getattr(rp, key)[0]).abs()[both]
        assert float(d.double().median()) < (1e-6 if f64 else 1e-3)


D853_EXTRAS_CASES = [("thin", 0), ("absorbed", 0), ("stokes", 0),
                     ("spectral", 2), ("spectral", 3), ("movie thin", 8),
                     ("movie absorbed", 8), ("order thin", 3),
                     ("order absorbed", 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("family,width", D853_EXTRAS_CASES,
                         ids=[f"{f} {w}" for f, w in D853_EXTRAS_CASES])
def test_dop853_extras_instance_matches_plain_version(cuda, family, width,
                                                      dtype):
    """Each extras functor's DOP853 instance at the main paths' width,
    against the plain DOP853 loop by test_every_extras_instance_matches_
    plain_version's gates."""
    _check_extras_instance(cuda, family, width, dtype, "dop853")


def test_every_dop853_extras_instance_fits_an_sm(cuda):
    """Every DOP853 extras instance meets its DP45 twin's block bound."""
    for label, entry, form, variant, dtype in vk.extras_instances("dop853"):
        d = vk.describe_instance(entry, form, variant, dtype, "dop853")
        assert d["blocks_per_sm"] >= d["min_blocks"] >= 1, (label, d)


def test_unknown_method_raises_on_a_cuda_tensor(cuda):
    """A CUDA tensor with a pair or interpolant the kernels have no
    instance of raises; nothing falls back to the plain loop."""
    m, _ac, al, th, ref = _rays(64, cuda)
    plain = kerr_trace.trace_rays_kerr.launches
    for kw, err in ((dict(method="rk45"), ValueError),
                    (dict(method="rk4"), ValueError),
                    (dict(event_interp="cubic"), ValueError)):
        with pytest.raises(err):
            trace_rays_kerr_cuda(m, R_OBS, al, th, np.pi / 2, ref, 5000.0,
                                 100, **kw)
    with pytest.raises(ValueError):
        trace_disk_rays_cuda(m, R_OBS, al, th, np.pi / 2, 5000.0, 100,
                             (6.0, 20.0, np.pi / 2, True), method="rk45")
    em, _ab = volumetric.make_transfer_fns(m, volumetric.RIAFConfig())
    with pytest.raises(ValueError):
        vk.trace_rays_volumetric_cuda(m, R_OBS, al, th, np.pi / 2, em,
                                      5000.0, 100, method="rk45")
    assert kerr_trace.trace_rays_kerr.launches == plain


def test_dop853_render_shadow_on_card_matches_cpu(cuda):
    """render_shadow with integrator="dop853" at 64^2 in float64: the
    DOP853 float64 instance on the card against the plain loop on the
    CPU, pixels equal on 99.9 %."""
    scene = SceneConfig(M=1.0, a=0.9, vertical_fov_deg=12.0)
    cfg = RenderConfig(dtype="float64", integrator="dop853")
    before = trace_rays_kerr_cuda.launches_dop853_f64
    ig, sg = pipeline.render_shadow(scene, (64, 64), cfg, device=cuda)
    ic, _sc = pipeline.render_shadow(scene, (64, 64), cfg, device="cpu")
    assert trace_rays_kerr_cuda.launches_dop853_f64 > before
    assert (ig.cpu() == ic).float().mean().item() >= 0.999
    assert (ic == 0).any() and sg["integrator_steps"] > 0


# The mu chart (csrc/kerr_dp45_mu.cu and siblings) and the Kerr-Newman
# flow of the extras kernel (csrc/*_kn.cu).

MU_METRICS = {"kerr": Kerr(M=1.0, a=0.9),
              "kerr_newman": KerrNewman(M=1.0, a=0.6, Q=0.6)}


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("family", list(MU_METRICS))
def test_mu_kernel_matches_plain_mu_loop_bitwise(cuda, family, dtype,
                                                 method):
    """Each mu instance against the plain mu loop on the card, both capped
    at 256 attempts, with the hybrid's poison mask: every output bitwise
    (the kernel calls the same libdevice functions as torch, in the same
    order, without FMA contraction)."""
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        counter_name)
    m = MU_METRICS[family]
    ac = m.alpha_crit(R_OBS)
    rng = np.random.default_rng(11)
    n = 1024
    kw = dict(dtype=dtype, device=cuda)
    al = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, n), **kw)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, n), **kw)
    ref = torch.tensor(rng.random(n) < 0.2, device=cuda)
    fi = torch.tensor(rng.random(n) < 0.05, device=cuda)
    name = counter_name(dtype, method, "mu")
    before = getattr(trace_rays_kerr_cuda, name)
    args = (m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 256)
    kw = dict(formulation="mu", method=method, force_invalid=fi,
              return_unconverged=True)
    rk, uk = trace_rays_kerr_cuda(*args, **kw)
    rp, up = kerr_trace.trace_rays_kerr(*args, **kw)
    assert getattr(trace_rays_kerr_cuda, name) == before + 1
    for a, b in zip(rk, rp):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    assert torch.equal(uk, up)
    assert (rk.status[fi] == kerr_trace.INVALID).all()
    assert (rk.status == 1).sum() > n // 2


def test_cuda_hybrid_matches_plain_loop_through_it(cuda):
    """The CUDA hybrid (Pallas semantics) on a 64^2 camera grid with its
    pole column, first pass capped at 64: the same driver over the plain
    loop gives every output bitwise; the poisoned rays are the pole
    column's and each was traced in theta."""
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_rays_kerr_hybrid)
    m = Kerr(M=1.0, a=0.9)
    res = (64, 64)
    fov = camera.fov_from_vertical(np.radians(40.0), res)
    al = camera.build_alpha_lookup(res, fov, device=cuda).reshape(-1)
    th = camera.build_theta_lookup(res, fov, device=cuda).reshape(-1)
    ref = torch.zeros(al.shape, dtype=torch.bool, device=cuda)
    args = (m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 2000)
    probe = {}
    rk = trace_rays_kerr_hybrid(*args, pass1_steps=64, probe=probe)
    rp = trace_rays_kerr_hybrid(*args, pass1_steps=64,
                                trace_fn=kerr_trace.trace_rays_kerr)
    for a, b in zip(rk, rp):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    poison = probe["poison"].reshape(res)
    assert poison[:, res[1] // 2].all() and 0 < int(poison.sum()) < 8 * 64
    assert int(probe["redo"].sum()) >= int(poison.sum())


def test_mu_chart_raises_where_it_has_no_instance(cuda):
    m, _ac, al, th, ref = _rays(64, cuda)
    jp = JohannsenPsaltis(M=1.0, a=0.9, eps3=2.0)
    plain = kerr_trace.trace_rays_kerr.launches
    with pytest.raises(NotImplementedError):
        trace_rays_kerr_cuda(jp, R_OBS, al, th, np.pi / 2, ref, 5000.0, 10,
                             formulation="mu")
    with pytest.raises(ValueError):
        trace_disk_rays_cuda(m, R_OBS, al, th, np.pi / 2, 5000.0, 10,
                             (6.0, 20.0, np.pi / 2, True), formulation="mu")
    with pytest.raises(ValueError):
        trace_rays_kerr_cuda(m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 10,
                             force_invalid=ref)
    with pytest.raises(ValueError):
        trace_rays_kerr_cuda(m, R_OBS, al, th, np.pi / 2, ref, 5000.0, 10,
                             formulation="cos")
    assert kerr_trace.trace_rays_kerr.launches == plain


@pytest.mark.parametrize("family", list(MU_METRICS))
def test_render_shadow_mu_on_card_matches_cpu(cuda, family):
    """render_shadow with formulation="mu" at 64^2 in float64: the CUDA
    hybrid on the card against the plain hybrid on the CPU, pixels equal
    on 99.9 %; the mu instance launched."""
    m = MU_METRICS[family]
    scene = SceneConfig(M=1.0, a=m.a, Q=getattr(m, "Q", 0.0),
                        vertical_fov_deg=12.0)
    cfg = RenderConfig(dtype="float64", formulation="mu")
    before = trace_rays_kerr_cuda.launches_mu_f64
    ig, _sg = pipeline.render_shadow(scene, (64, 64), cfg, device=cuda)
    ic, _sc = pipeline.render_shadow(scene, (64, 64), cfg, device="cpu")
    assert trace_rays_kerr_cuda.launches_mu_f64 > before
    assert (ig.cpu() == ic).float().mean().item() >= 0.999


# Every Kerr-Newman extras instance (no Stokes: the polarized form is
# Kerr-only), as vk.extras_instances(method, "_kn") lists them.
KN_EXTRAS_CASES = [c for c in WIDTH_CASES if c[0] != "stokes"]


def _instance_form(family, width):
    """The functor of an extras instance's label that a case launches."""
    if family in ("thin", "absorbed"):
        return f"Vol{family.capitalize()}<"
    if family == "spectral":
        return f"Spectral<{width},"
    kind, which = family.split()
    return f"{kind.capitalize()}<{width},absorbing={int(which == 'absorbed')},"


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("family,width", KN_EXTRAS_CASES,
                         ids=[f"{f} {w}" for f, w in KN_EXTRAS_CASES])
def test_kerr_newman_extras_instance_matches_plain_version(
        cuda, family, width, dtype, method):
    """Every Kerr-Newman instance (a = 0.6, Q = 0.6), both pairs and both
    dtypes, against the plain loop by
    test_every_extras_instance_matches_plain_version's gates."""
    _check_extras_instance(cuda, family, width, dtype, method,
                           metric=KerrNewman(M=1.0, a=0.6, Q=0.6))


def test_every_kerr_newman_extras_instance_fits_an_sm(cuda):
    """Every Kerr-Newman instance meets its block bound, and the cases of
    test_kerr_newman_extras_instance_matches_plain_version launch every
    one of them."""
    cases = sorted(_instance_form(f, w) for f, w in KN_EXTRAS_CASES)
    for method in ("dp45", "dop853"):
        rows = vk.extras_instances(method, "_kn")
        for dtype in (torch.float32, torch.float64):
            forms = sorted(label.split("<", 1)[1].rsplit(
                "float" if dtype == torch.float32 else "double", 1)[0]
                for label, _e, _f, _v, d in rows if d == dtype)
            assert forms == cases, (method, dtype)
        for label, entry, form, variant, dtype in rows:
            d = vk.describe_instance(entry, form, variant, dtype, method)
            assert d["blocks_per_sm"] >= d["min_blocks"] >= 1, (label, d)


def test_charged_volumetric_render_on_card_matches_cpu(cuda):
    """render_volumetric of a charged scene at 64^2 in float64, the card
    against the CPU (median |d image| < 1e-6); the polarized form with a
    charge raises as on the CPU."""
    scene = SceneConfig(M=1.0, a=0.6, Q=0.6, theta_obs=THETA_DISK,
                        vertical_fov_deg=16.0)
    cfg = RenderConfig(dtype="float64")
    before = vk.trace_rays_volumetric_cuda.launches_f64
    ig, _sg = volumetric.render_volumetric(scene, (64, 64), cfg,
                                           device=cuda)
    ic, _sc = volumetric.render_volumetric(scene, (64, 64), cfg,
                                           device="cpu")
    assert vk.trace_rays_volumetric_cuda.launches_f64 > before
    assert np.median(np.abs(ig.cpu().numpy() - ic.numpy())) < 1e-6
    with pytest.raises(ValueError, match="uncharged Kerr"):
        polarization.render_polarized_volumetric(scene, (8, 8), cfg,
                                                 device=cuda)


def _wide_plane():
    """The photon-ring decomposition's recorder (every plane crossing)."""
    return (0.0, 2.0 * R_OBS, float(np.pi / 2), False)


def _near_critical(m, n, device, dtype):
    """n rays just outside m's critical curve (bisection on the shadow
    kernel's capture at each screen angle, then a factor 1 + eps, eps
    log-uniform in [1e-7, 1e-3]), beside n of phase 8's random rays."""
    rng = np.random.default_rng(24)
    f32 = dict(dtype=torch.float32, device=device)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, 2 * n), **f32)
    ac = m.alpha_crit(R_OBS, THETA_DISK)
    lo, hi = torch.full((n,), 0.3 * ac, **f32), torch.full((n,), 3 * ac,
                                                           **f32)
    ref = torch.zeros(n, dtype=torch.bool, device=device)
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        cap = trace_rays_kerr_cuda(m, R_OBS, mid, th[n:], THETA_DISK, ref,
                                   5000.0, 20000).status == -1
        lo, hi = torch.where(cap, mid, lo), torch.where(cap, hi, mid)
    eps = torch.tensor(1.0 + 10.0 ** rng.uniform(-7.0, -3.0, n), **f32)
    al = torch.cat([torch.tensor(rng.uniform(0.01, 0.12, n), **f32),
                    hi * eps])
    return al.to(dtype).contiguous(), th.to(dtype).contiguous()


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", ["kerr", "kerr_newman"])
@pytest.mark.parametrize("momentum", [False, True])
def test_wide_disk_instances(cuda, method, dtype, family, momentum):
    """8 slots: slots 0-3, the status, final_alpha and min(n_hits, 4)
    bitwise the 4-slot instance's; against the plain loop the disk gates
    on every slot; some rays fill slot 5 and up."""
    m = (Kerr(M=1.0, a=0.9) if family == "kerr"
         else KerrNewman(M=1.0, a=0.6, Q=0.6))
    al, th = _near_critical(m, 1024, cuda, dtype)
    args = (m, R_OBS, al, th, THETA_DISK, 5000.0, 1000, _wide_plane())
    kw = dict(record_momentum=momentum, method=method)
    wide_before = getattr(trace_disk_rays_cuda, "launches_wide"
                          + ("_dop853" if method == "dop853" else "")
                          + ("_f64" if dtype == torch.float64 else ""))
    rk = trace_disk_rays_cuda(*args, 8, **kw)
    narrow = trace_disk_rays_cuda(*args, 4, **kw)
    torch.cuda.synchronize()
    assert getattr(trace_disk_rays_cuda, "launches_wide"
                   + ("_dop853" if method == "dop853" else "")
                   + ("_f64" if dtype == torch.float64 else "")) \
        == wide_before + 1
    assert len(rk.r_hits) == 8 and len(rk.pr_hits) == (8 if momentum else 0)
    pairs = [(rk.status, narrow.status),
             (rk.final_alpha.nan_to_num(9.0), narrow.final_alpha.nan_to_num(
                 9.0)), (rk.n_hits.clamp(max=4), narrow.n_hits)]
    for field in ("r_hits", "phi_hits", "pr_hits", "pth_hits"):
        pairs += list(zip(getattr(rk, field)[:4], getattr(narrow, field)))
    for a, b in pairs:
        assert torch.equal(a, b)
    nk = rk.n_hits.cpu().numpy()
    assert (nk > 4).sum() > 0
    rp = trace_disk_rays_plain(*args, 8, **kw)
    npl = rp.n_hits.cpu().numpy()
    assert (rk.status.cpu().numpy() == rp.status.cpu().numpy()).mean() > 0.99
    assert (nk == npl).mean() > 0.99
    for k in range(8):
        both = (nk > k) & (npl > k)
        if both.any():
            d = np.abs(rk.r_hits[k].cpu().numpy()[both]
                       - rp.r_hits[k].cpu().numpy()[both])
            assert np.median(d) < 1e-3 and np.percentile(d, 99) < 0.1


def test_wide_disk_rejects_nine_slots(cuda):
    """Nine slots and more go through the plane recorder as one
    equatorial plane (no wide launch), bitwise the plain loop on the card
    in every output."""
    m = Kerr(M=1.0, a=0.9)
    al, th = _near_critical(m, 1024, cuda, torch.float32)
    before = (trace_disk_rays_cuda.launches_wide,
              trace_disk_rays_cuda.launches_planes)
    args = (m, R_OBS, al, th, THETA_DISK, 5000.0, 1000, _wide_plane(), 9)
    rk = trace_disk_rays_cuda(*args, record_momentum=True)
    assert (trace_disk_rays_cuda.launches_wide,
            trace_disk_rays_cuda.launches_planes) == (before[0],
                                                      before[1] + 1)
    rp = trace_disk_rays_plain(*args, record_momentum=True)
    assert len(rk.r_hits) == len(rk.pr_hits) == 9
    assert SMOKE.p25_bitwise((rk,), (rp,)) == {}
    r = disk.trace_disk_rays(m, R_OBS, al, al, THETA_DISK, 5000.0, 100,
                             disk.DiskConfig(opaque=False, max_hits=8))
    assert len(r.r_hits) == 8


def _smoke():
    """chip_smoke.py, whose phase 24 renders and gates the disk-mode test
    reuses."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()


@pytest.mark.parametrize("mode", SMOKE.P24_MODES)
def test_disk_mode_on_card_matches_cpu(cuda, mode):
    """chip_smoke.py phase 24's 64^2 render of each disk mode on the card
    against the CPU, by its gates (p24_check); the card's render launches
    the disk kernel and never the plain loop."""
    before = SMOKE.disk_launches()
    plain = kerr_trace.trace_disk_rays_kerr.launches
    og = SMOKE.p24_render(mode, SMOKE.P24_CHECK, cuda, check=True)
    assert SMOKE.disk_launches() > before
    assert kerr_trace.trace_disk_rays_kerr.launches == plain
    oc = SMOKE.p24_render(mode, SMOKE.P24_CHECK, "cpu", check=True)
    row, ok = SMOKE.p24_check(mode, og, oc)
    assert ok, row


@pytest.mark.parametrize("name", ["tilt", "opaque", "translucent"])
@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", ["kerr", "kerr_newman"])
def test_plane_recorder_bitwise_plain_loop(cuda, family, dtype, method,
                                           name):
    """chip_smoke.py phase 25's plane sets (one tilted plane; an opaque
    equatorial disk and tilted ring with crossing times; a warped and a
    tilted translucent plane with crossing times and momenta) through the
    plane-recorder instance, bitwise the plain loop on the card in every
    output of every plane, on 1,024 random and 1,024 near-critical rays."""
    m = (Kerr(M=1.0, a=0.9) if family == "kerr"
         else KerrNewman(M=1.0, a=0.6, Q=0.6))
    al, th = _near_critical(m, 1024, cuda, dtype)
    before = getattr(trace_disk_rays_cuda, "launches_planes"
                     + ("_dop853" if method == "dop853" else "")
                     + ("_f64" if dtype == torch.float64 else ""))
    rk = SMOKE.p25_trace(family, al, th, name, method)
    assert getattr(trace_disk_rays_cuda, "launches_planes"
                   + ("_dop853" if method == "dop853" else "")
                   + ("_f64" if dtype == torch.float64 else "")) \
        == before + 1
    rp = SMOKE.p25_trace(family, al, th, name, method, kernel=False)
    assert SMOKE.p25_bitwise(rk, rp) == {}
    assert all(int((r.n_hits > 0).sum()) > 0 for r in rk)


@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_equatorial_plane_recorder_is_the_disk_variant(cuda, dtype, method):
    """The equatorial plane with the time recorder (the plane recorder's
    kind 0) equals the disk variant bitwise in every output both write."""
    m = Kerr(M=1.0, a=0.9)
    al, th = _near_critical(m, 1024, cuda, dtype)
    plane = (disk.r_isco(1.0, 0.9), 20.0, float(np.pi / 2), True)
    a = SMOKE.kk_disk(m, al, th, plane, method=method)
    b = SMOKE.kk_disk(m, al, th, plane, method=method, record_time=True)
    for x, y in ((a.status, b.status), (a.n_hits, b.n_hits),
                 (a.n_half, b.n_half), *zip(a.r_hits, b.r_hits),
                 *zip(a.phi_hits, b.phi_hits)):
        assert torch.equal(x, y)
    assert torch.equal(a.final_alpha.nan_to_num(9.0),
                       b.final_alpha.nan_to_num(9.0))
    assert len(b.t_hits) == 2 and b.t_end.shape == al.shape


def test_plane_recorder_rejects_three_planes(cuda):
    """Three planes go to the plane recorder's broad instance (one launch
    on its counter), bitwise the plain loop on the card in every output
    of every plane."""
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_disk_rays_multi_cuda)
    m = Kerr(M=1.0, a=0.9)
    al, th = _near_critical(m, 512, cuda, torch.float32)
    plane = (disk.r_isco(1.0, 0.9), 20.0, float(np.pi / 2), True)
    planes = [(plane, None), ((3.0, 20.0, float(np.pi / 2), False),
                              disk.disk_basis(0.5, 0.7))] * 2
    before = trace_disk_rays_cuda.launches_broad
    args = (m, R_OBS, al, th, THETA_DISK, 5000.0, 400)
    rk = trace_disk_rays_multi_cuda(*args, planes[:3], record_time=True)
    assert trace_disk_rays_cuda.launches_broad == before + 1
    rp = trace_disk_rays_plain(*args, plane, 2, extra_disks=planes[1:3],
                               record_time=True)
    assert len(rk) == 3 and SMOKE.p25_bitwise(rk, rp) == {}


@pytest.mark.parametrize("mode", SMOKE.P25_MODES)
def test_phase25_mode_on_card_matches_cpu(cuda, mode):
    """chip_smoke.py phase 25's 64^2 render of each mode (tilted, warped
    and second disks, the delayed light curve, the boosted renders) on the
    card against the CPU by its gates (p25_check); the card never calls a
    plain loop."""
    SMOKE.p25_zero()
    og = SMOKE.p25_render(mode, SMOKE.P24_CHECK, cuda)
    n = SMOKE.p25_counts()
    assert n["plain_loop_calls"] == 0 and sum(
        v for k, v in n.items() if k != "plain_loop_calls") > 0
    oc = SMOKE.p25_render(mode, SMOKE.P24_CHECK, "cpu")
    row, ok = SMOKE.p25_check(mode, og, oc)
    assert ok, row


@pytest.mark.parametrize("label", list(SMOKE.P26_NARROW))
@pytest.mark.parametrize("method", ["dp45", "dop853"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", ["kerr", "kerr_newman"])
def test_broad_form_is_its_narrow_instance(cuda, family, dtype, method,
                                           label):
    """chip_smoke.py phase 26: each broad extras form at a narrow width
    (3 bands, 8 frames, 4 orders) bitwise its compiled narrow instance on
    1,024 random rays, and a wider one (16 frames, 40 bands, 6 orders)
    bitwise the plain loop on the card."""
    rng = np.random.default_rng(0)
    al = torch.tensor(rng.uniform(0.01, 0.12, 1024), dtype=dtype,
                      device=cuda)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, 1024), dtype=dtype,
                      device=cuda)
    a = SMOKE.p26_launch(family, al, th, label, method, broad=False)
    b = SMOKE.p26_launch(family, al, th, label, method, broad=True)
    assert SMOKE.p26_extras_bitwise(a, b)
    wide = {"spectral": "spectral 40", "movie": "movie 16 thin",
            "orders": "orders 6 absorbed"}[label.split()[0]]
    before = getattr(vk.trace_rays_aux_cuda, kk_counter(dtype, method))
    rk = SMOKE.p26_trace(family, al[:256], th[:256], wide, method)
    assert getattr(vk.trace_rays_aux_cuda,
                   kk_counter(dtype, method)) == before + 1
    rp = SMOKE.p26_trace(family, al[:256], th[:256], wide, method,
                         kernel=False)
    assert SMOKE.p26_extras_bitwise(rk, rp)


def kk_counter(dtype, method):
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        counter_name)
    return counter_name(dtype, method, "broad")


@pytest.mark.parametrize("timed", [False, True], ids=["plain", "time"])
@pytest.mark.parametrize("family", list(SMOKE.P27_FAMILIES))
@pytest.mark.parametrize("dtype", ["float32", "float64"],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("method", ["dp45", "dop853"])
def test_surface_instance_is_its_plain_loop(cuda, method, dtype, family,
                                            timed):
    """chip_smoke.py phase 27: each surface kernel instance (pair, dtype,
    family, with and without the time component) bitwise the plain loop
    on the card on 1,024 of its random rays, counted on its own counter
    and never running the plain loop through the wrapper."""
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    al, th = (x[:1024] for x in SMOKE.p27_rays(cuda, dtype))
    name = SMOKE.p27_counter(method, dtype, family, timed)
    before = getattr(sk.trace_rays_surface_cuda, name)
    plain = kerr_trace.trace_rays_surface.launches
    rk = SMOKE.p27_trace(family, al, th, method, timed)
    assert getattr(sk.trace_rays_surface_cuda, name) == before + 1
    assert kerr_trace.trace_rays_surface.launches == plain
    rp = SMOKE.p27_trace(family, al, th, method, timed, kernel=False)
    assert SMOKE.p27_bitwise(rk, rp), SMOKE.p27_max_abs(rk, rp)
    assert int((rk.status == 1).sum()) > 0
    assert int((rk.status == -1).sum()) > 0
    if not timed:
        assert not bool(rk.t_hit.any())


def test_surface_kernel_refuses_what_it_lacks(cuda):
    """A CUDA tensor the surface kernel takes no instance of raises
    before a launch: another metric class, another dtype, another
    pair."""
    from light_path_tracer_tpu_torch.ops.cuda import surface_kernel as sk
    al, th = SMOKE.p27_rays(cuda, "float32")
    args = (R_OBS, al, th, 1.4, 2.0, 5000.0, 100)
    with pytest.raises(TypeError):
        sk.trace_rays_surface_cuda(Schwarzschild(M=1.0), *args)
    with pytest.raises(ValueError):
        sk.trace_rays_surface_cuda(Kerr(M=1.0, a=0.9), R_OBS, al.half(),
                                   th.half(), 1.4, 2.0, 5000.0, 100)
    with pytest.raises(ValueError):
        sk.trace_rays_surface_cuda(Kerr(M=1.0, a=0.9), *args, method="rk4")


@pytest.mark.parametrize("mode", SMOKE.P27_MODES)
def test_phase27_mode_on_card_matches_cpu(cuda, mode):
    """chip_smoke.py phase 27's 64^2 render of each map mode on the card
    against the CPU by its gates (p27_check); the card never calls a
    plain loop."""
    SMOKE.p27_zero()
    og, _ = SMOKE.p27_render(mode, SMOKE.P27_CHECK, cuda)
    n = SMOKE.p27_counts()
    assert n["plain"] == 0 and sum(v for k, v in n.items()
                                   if k != "plain") > 0
    oc, _ = SMOKE.p27_render(mode, SMOKE.P27_CHECK, "cpu")
    row = SMOKE.p27_check(mode, og, oc)
    assert all(v["ok"] for v in row.values()), row


@pytest.mark.parametrize("form", list(SMOKE.P28_DYN))
@pytest.mark.parametrize("chart", SMOKE.P28_CHARTS)
def test_dynamic_launch_is_its_plain_loop(cuda, chart, form):
    """chip_smoke.py phase 28: the Kerr kernel's theta and mu instances
    with run-time (M, a) and (M, a, r_obs) bitwise the plain loop on the
    card on 1,024 of phase 8's rays, counted on the dynamic_ counter of
    the chart and never running the plain loop through the wrapper."""
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    al, th = (x[:1024] for x in SMOKE.p28_rays(cuda))
    name = "dynamic_" + kk.counter_name(torch.float32, "dp45", chart)
    before = getattr(kk.trace_rays_kerr_cuda, name)
    plain = kerr_trace.trace_rays_kerr.launches
    rk = SMOKE.p28_trace(chart, form, al, th)
    assert getattr(kk.trace_rays_kerr_cuda, name) == before + 1
    assert kerr_trace.trace_rays_kerr.launches == plain
    rp = SMOKE.p28_trace(chart, form, al, th, kernel=False)
    assert SMOKE.p28_bitwise(rk, rp)
    assert int((rk[0].status == 1).sum()) > 0
    assert int((rk[0].status == -1).sum()) > 0


def test_dynamic_hybrid_is_plain_loop_through_it(cuda):
    """The hybrid with run-time (M, a, r_obs) on 65,536 rays of phase 28's
    1024^2 flyby frame, capped at 512, bitwise the same driver over the
    plain loop."""
    from light_path_tracer_tpu_torch.models import Kerr as K
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    fa, ft = (x[::16].contiguous() for x in SMOKE.p28_frame_rays(cuda))
    args = (K(M=1.0, a=0.0), R_OBS, fa, ft, np.pi / 2,
            torch.zeros(fa.shape, dtype=torch.bool, device=cuda), 5000.0,
            512)
    kw = dict(pass1_steps=512, dynamic_params=(1.0, 0.9, 20.0))
    rk = kk.trace_rays_kerr_hybrid(*args, **kw)
    rp = kk.trace_rays_kerr_hybrid(*args, trace_fn=trace_rays_kerr_plain,
                                   **kw)
    assert all(SMOKE.same_bits(a.cpu(), b.cpu()) for a, b in zip(rk, rp))


def test_dynamic_float64_raises_on_card(cuda):
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    al, th = (x[:64].double() for x in SMOKE.p28_rays(cuda))
    ar = torch.zeros(64, dtype=torch.bool, device=cuda)
    for dyn in SMOKE.P28_DYN.values():
        with pytest.raises(ValueError, match="float32"):
            kk.trace_rays_kerr_cuda(Kerr(M=1.0, a=0.0), R_OBS, al, th,
                                    np.pi / 2, ar, 5000.0, 100,
                                    dynamic_params=dyn)


@pytest.mark.parametrize("mode", SMOKE.P28_MODES)
def test_phase28_mode_on_card_matches_cpu(cuda, mode):
    """chip_smoke.py phase 28's 64^2 render of each mode on the card
    against the CPU by its gates (p28_check); the card never calls a
    plain loop."""
    SMOKE.p28_zero()
    og = SMOKE.p28_render(mode, SMOKE.P28_CHECK, cuda)
    n = SMOKE.p28_counts()
    assert n["plain"] == 0 and sum(v for k, v in n.items()
                                   if k != "plain") > 0
    oc = SMOKE.p28_render(mode, SMOKE.P28_CHECK, "cpu")
    row = SMOKE.p28_check(mode, og, oc)
    assert all(v["ok"] for v in row.values()), row


class _eager_blocks:
    """Within: the loops' step_blocks run every block eagerly."""

    def __enter__(self):
        from light_path_tracer_tpu_torch import trajectory
        from light_path_tracer_tpu_torch.ops import graphs, kerr_rk4

        def no_graph(*a, **kw):
            return graphs.step_blocks(*a, **dict(kw, graph=False))
        self.mods = (trajectory, kerr_rk4, kerr_trace)
        for m in self.mods:
            m.step_blocks = no_graph

    def __exit__(self, *exc):
        from light_path_tracer_tpu_torch.ops import graphs
        for m in self.mods:
            m.step_blocks = graphs.step_blocks


def test_graph_blocks_bitwise_the_eager_loops(cuda):
    """The CUDA-graph blocks of the 8-D recorder, the RK4 loop and a
    CustomMetric's adaptive loop against the same loops run eagerly."""
    from light_path_tracer_tpu_torch import particles as pt
    from light_path_tracer_tpu_torch.models import load_user_metric
    from light_path_tracer_tpu_torch.ops.kerr_rk4 import trace_rays_kerr_rk4
    m = Kerr(M=1.0, a=0.9)
    E, L = pt.orbit_from_apsides(m, 8.0, 16.0)
    s8, _ = pt.timelike_initial_conditions(
        m, torch.tensor(8.0, dtype=torch.float64, device=cuda), E, L)
    _m, _ac, al, th, ref = _rays(512, cuda)
    hay = load_user_metric(str(Path(__file__).resolve().parents[1]
                               / "examples" / "user_metric_torch.py")
                           + ":hayward")
    runs = (lambda: pt.integrate_orbit(m, s8, n_steps=100),
            lambda: trace_rays_kerr_rk4(m, R_OBS, al, th, np.pi / 2, ref,
                                        5000.0, 200000),
            lambda: kerr_trace.trace_rays_kerr(hay, R_OBS, al[:64], th[:64],
                                               np.pi / 2, ref[:64], 5000.0,
                                               4000))
    for run in runs:
        graphed = run()
        with _eager_blocks():
            eager = run()
        for a, b in zip(graphed, eager):
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_custom_metric_and_rk4_on_card(cuda):
    """A CustomMetric traces on the plain loop on a CUDA tensor (no kernel
    launch; backend="cuda" refused) and equals the CPU's in float64, as
    does the fixed-step RK4."""
    from light_path_tracer_tpu_torch.models import (CustomMetric,
                                                    kerr_covariant)
    from light_path_tracer_tpu_torch.ops.batch import trace_batch
    cm = CustomMetric(M=1.0, a=0.9, covariant_fn=kerr_covariant(1.0, 0.9))
    m, _ac, al, th, ref = _rays(64, cuda)
    al, th = al.double(), th.double()
    with pytest.raises(ValueError):
        trace_batch(cm, R_OBS, al, th, backend="cuda")
    p0 = kerr_trace.trace_rays_kerr.launches
    for metric, kw in ((cm, dict(max_steps=4000)),
                       (m, dict(integrator="rk4"))):
        k0 = trace_rays_kerr_cuda.launches_f64
        rg = trace_batch(metric, R_OBS, al, th, np.pi / 2, ref, **kw)
        assert trace_rays_kerr_cuda.launches_f64 == k0
        rc = trace_batch(metric, R_OBS, al.cpu(), th.cpu(), np.pi / 2,
                         ref.cpu(), **kw)
        assert torch.equal(rg.status.cpu(), rc.status)
        esc = rc.status == 1
        assert (rg.final_alpha.cpu()[esc] - rc.final_alpha[esc]).abs().max() \
            < 1e-9
    assert kerr_trace.trace_rays_kerr.launches == p0 + 2


@pytest.mark.parametrize("name", ("kerr", "schwarzschild"))
def test_phase29_paths_on_card_match_cpu(cuda, name):
    """chip_smoke.py phase 29's ten angles in float64 (trace_ray through
    the kernels, the 8-D paths) on the card against the CPU."""
    row, ok = SMOKE.p29_paths_check(name, SMOKE.p29_paths(name, "cuda"),
                                    SMOKE.p29_paths(name, "cpu"))
    assert ok, row


def test_serve_handler_thread_equals_main_thread(cuda):
    """A /render on the server's handler thread (its kernels on that
    thread's current stream) equals the same render on this thread
    bitwise; /healthz names the card."""
    import io
    import json
    import threading
    import urllib.request
    from light_path_tracer_tpu_torch import serve
    server = serve.make_server(port=0,
                               service=serve.RenderService(device="cuda"))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = "http://%s:%d" % server.server_address[:2]
    req = {"mode": "shadow", "size": [256, 256], "format": "npy",
           "scene": {"a": 0.9, "r_obs_mult": R_OBS}}
    try:
        with urllib.request.urlopen(url + "/healthz") as resp:
            assert json.loads(resp.read()) == {
                "ok": True, "devices": torch.cuda.device_count(),
                "platform": "gpu"}
        k0 = trace_rays_kerr_cuda.launches
        with urllib.request.urlopen(urllib.request.Request(
                url + "/render", data=json.dumps(req).encode())) as resp:
            got = np.load(io.BytesIO(resp.read()))
        assert trace_rays_kerr_cuda.launches > k0
    finally:
        server.shutdown()
        server.server_close()
    _mode, scene, cfg, *_ = serve.decode_request(req)
    img, _stats = pipeline.render_shadow(scene, (256, 256), cfg,
                                         device="cuda")
    assert got.tobytes() == img.cpu().numpy().tobytes()


def test_device_memory_keys(cuda):
    from light_path_tracer_tpu_torch.utils.telemetry import device_memory
    x = torch.ones(1 << 20, device=cuda)
    out = device_memory()
    assert list(out) == [f"cuda:{i}" for i in
                         range(torch.cuda.device_count())]
    stats = out[f"cuda:{cuda.index}"]
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]


def test_trace_batch_progress_and_store_on_card(cuda, tmp_path):
    """The chunked trace with the live bar and a chunk store (a host sync
    a chunk) equals it without them bitwise; stored chunks come back on
    the card."""
    import contextlib
    import io
    from light_path_tracer_tpu_torch.checkpoint import ChunkStore
    from light_path_tracer_tpu_torch.ops.batch import trace_batch
    m, _ac, al, th, ref = _rays(4096, cuda)
    kw = dict(chunk_size=1024, max_steps=20000)
    plain = trace_batch(m, R_OBS, al, th, np.pi / 2, ref, **kw)
    store = ChunkStore(str(tmp_path), "k")
    with contextlib.redirect_stderr(io.StringIO()) as err:
        live = trace_batch(m, R_OBS, al, th, np.pi / 2, ref,
                           progress="live", chunk_store=store, **kw)
    again = trace_batch(m, R_OBS, al, th, np.pi / 2, ref, chunk_store=store,
                        **kw)
    assert "4/4" in err.getvalue() and len(store.chunk_starts()) == 4
    for res in (live, again):
        for a, b in zip(res, plain):
            assert a.device == b.device and torch.equal(
                torch.nan_to_num(a), torch.nan_to_num(b))
