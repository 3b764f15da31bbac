"""PyTorch/CUDA port of light_path_tracer_tpu, the general-relativistic
ray tracer.

The JAX package `light_path_tracer_tpu` is the reference; this package
mirrors its layout and names module by module, in plain PyTorch, with
every TPU kernel on a ported path rewritten as a hand-written CUDA kernel
for Hopper (csrc/). Ported so far: the shadow (`render_shadow`) and the
lensed render (`render_scene`) for Kerr, Schwarzschild,
Reissner-Nordstrom, Kerr-Newman and Johannsen-Psaltis, through `trace_batch` (whole-grid, or chunked and
difficulty-sorted) to the CUDA DP45 kernel (`ops/cuda/kerr_trace_kernel.py`)
or the CUDA RK4 orbit kernel (`ops/cuda/schwarzschild_kernel.py`) on a
CUDA device, or to their plain PyTorch loops (`ops/kerr_trace.py`,
`ops/schwarzschild_trace.py`) on the CPU.

Config 5, the jittered-AA shadow and lensed render (`aa.py`:
`render_shadow_aa`, `render_scene_aa`; `adaptive.py`:
`render_shadow_adaptive`, `render_scene_adaptive`), traces the stacked
AA passes through `trace_batch`, in pass-sized chunks above 8M rays.

The accretion-disk still render (`render_disk`, config 4; Kerr, or
Kerr-Newman for a charged scene), the photon-ring decomposition
(`render_disk_decomposed`), the hot-spot frames (`render_disk_frames`),
the jittered-AA render (`render_disk_aa`), the lensed composite with the
disk (`render_scene_with_disk`, `render_scene_with_disk_aa`), the
emission-line profile and hot-spot light curve (`spectra.py`:
`line_profile`, `hotspot_light_curve`) and the polarized disk
(`render_polarization`, `polarization.hotspot_qu_loop`) trace through the
kernel's disk variant (`trace_disk_rays_cuda`; 5 to 8 crossing slots
through its wide instances, more through the plane recorder), by default
inside the two-pass straggler driver (`trace_disk_rays_two_pass`);
tilted and warped disks, several planes in one trace
(`render_multi_disk`; three or more through the plane recorder's broad
instances) and the crossing-time recorder (the retarded-time light
curve) through its plane-recorder instances. A
moving camera (`SceneConfig.boost`) aberrates every render's grids;
`observables.py` reads rendered images in the visibility domain.

The volumetric hot-flow image (`render_volumetric`, optically thin or
self-absorbed), the multi-frequency spectral image
(`render_volumetric_spectrum`), the flare movie
(`render_volumetric_movie`), the photon-ring order decomposition
(`render_volumetric_decomposed`) and the polarized image
(`render_polarized_volumetric`) trace through the CUDA extras kernel
(`ops/cuda/volumetric_kernel.py`; more than 8 bands or frames and more
than 4 orders through its broad instances), by default inside its
two-pass drivers.

The lens-map products: the photon-ring layers (`render_rings`,
`render_scene_rings`) and the magnification map (`render_magnification`)
read the standard trace; caustics (`render_caustics`), the microlensing
light curve (`render_microlens_curve`), the arrival-time map
(`render_time_delay`), the shear maps (`render_shear`) and the
point-image solver (`images.find_point_images`) trace the whole grid
onto the capture surface through the CUDA surface kernel
(`ops/cuda/surface_kernel.py`), as do the stellar-surface images and
pulse profiles (`star.py`: `render_star`, `pulse_profile`).

Frame sequences (`sequence.py`: camera pans `render_sequence`, spin and
mass sweeps `render_param_sequence`, flybys `render_flyby`) trace through
the hybrid tracer with the Kerr kernel's run-time (M, a) and (M, a,
r_obs) (`dynamic_params`); 360-degree panoramas (`pano.py`:
`render_panorama`) through `trace_batch`.

The paths that run no Pallas kernel in the JAX package are plain PyTorch
on every device, their blocks of steps replayed as CUDA graphs on the
card (`ops/graphs.py`): the 8-D path recorders (`trajectory.py`) and
timelike orbits (`particles.py`), the fixed-step RK4 tracer
(`ops/kerr_rk4.py`, `integrator="rk4"`), user-defined metrics
(`models.CustomMetric`) and the differentiable tracer and fit
(`diff.py`).

The serving shell: the HTTP render server (`serve.py`, the offline
`request` replay), the lookup-table cache and chunk resume
(`checkpoint.py`), chunk progress bars (`utils/progress.py`) and the
telemetry helpers (`utils/telemetry.py`).

This package imports torch and never jax.
"""

from light_path_tracer_tpu_torch.version import __version__
from light_path_tracer_tpu_torch.adaptive import (render_scene_adaptive,
                                                  render_shadow_adaptive)
from light_path_tracer_tpu_torch.disk import (
    DiskConfig, render_disk, render_disk_aa, render_disk_decomposed,
    render_disk_frames, render_multi_disk, render_scene_with_disk,
    render_scene_with_disk_aa)
from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman,
                                                ReissnerNordstrom,
                                                Schwarzschild, make_metric)
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.ops.types import TraceResult
from light_path_tracer_tpu_torch.images import find_point_images
from light_path_tracer_tpu_torch.pano import render_panorama
from light_path_tracer_tpu_torch.pipeline import (
    RenderOutput, precompute_final_alpha, render_caustics,
    render_magnification, render_microlens_curve, render_rings,
    render_scene, render_scene_rings, render_shadow, render_shear,
    render_time_delay)
from light_path_tracer_tpu_torch.polarization import (
    render_polarization, render_polarized_volumetric)
from light_path_tracer_tpu_torch.sequence import (render_flyby,
                                                  render_param_sequence,
                                                  render_sequence)
from light_path_tracer_tpu_torch.spectra import (hotspot_light_curve,
                                                 line_profile)
from light_path_tracer_tpu_torch.star import (StarConfig, pulse_profile,
                                              render_star)
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.volumetric import (
    RIAFConfig, render_volumetric, render_volumetric_decomposed,
    render_volumetric_movie, render_volumetric_spectrum)

__all__ = ["Kerr", "KerrNewman", "JohannsenPsaltis", "Schwarzschild",
           "ReissnerNordstrom", "make_metric",
           "trace_batch", "TraceResult", "RenderOutput",
           "precompute_final_alpha", "render_scene", "render_shadow",
           "RenderConfig", "SceneConfig", "DiskConfig", "render_disk",
           "render_disk_aa", "render_disk_decomposed", "render_disk_frames",
           "render_multi_disk",
           "render_scene_with_disk", "render_scene_with_disk_aa",
           "line_profile", "hotspot_light_curve", "render_polarization",
           "RIAFConfig", "render_volumetric", "render_volumetric_spectrum",
           "render_volumetric_movie", "render_volumetric_decomposed",
           "render_polarized_volumetric", "render_shadow_adaptive",
           "render_scene_adaptive", "render_rings", "render_scene_rings",
           "render_magnification", "render_caustics",
           "render_microlens_curve", "render_time_delay", "render_shear",
           "find_point_images", "render_sequence", "render_param_sequence",
           "render_flyby", "render_panorama", "StarConfig", "render_star",
           "pulse_profile", "__version__"]
