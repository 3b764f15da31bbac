"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Gates as chip_smoke.py. Kerr DP45: status agreement above 0.99 and p99
|d final_alpha| < 2e-3 on stable escaped rays (the two versions round
differently, nvcc contracts a*b + c into FMA, so step sequences differ at
the tolerance level). Orbit RK4 (fixed steps, so only roundings differ):
status agreement above 0.999, p99 |d final_alpha| < 1e-4 on stable
escaped rays, the alpha = 0 lane INVALID. The lensed render on the card
against the CPU: shadow masks agree on >= 99 %, bilinear image RMSE
< 1e-3 on pixels of winding < 2.
"""

import numpy as np
import pytest
import torch

from light_path_tracer_tpu_torch import pipeline
from light_path_tracer_tpu_torch.models import (Kerr, ReissnerNordstrom,
                                                Schwarzschild)
from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
    trace_rays_kerr_cuda, trace_rays_kerr_plain)
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
        trace_rays_kerr_cuda(m, R_OBS, al.double(), th.double(), np.pi / 2,
                             ref, 5000.0, 100)
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
        trace_rays_schwarzschild_cuda(m, R_OBS, al.double())
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
