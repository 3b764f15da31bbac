"""Unified scene/render configuration (stdlib only).

The same pair of frozen dataclasses as `light_path_tracer_tpu.utils.config`,
field for field, so a scene and its numerics knobs carry across the two
packages unchanged (`light_path_tracer_tpu_torch.convert`) and hash to the
same lookup-cache key (checkpoint.cache_key).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Physics + camera scene description."""

    M: float = 1.0
    a: float = 0.0
    # Black-hole charge in units of M (Reissner-Nordstrom when != 0 at
    # a = 0, Kerr-Newman with a != 0 — models.make_metric).
    Q: float = 0.0
    # Johannsen-Psaltis deformation (test-GR deformed Kerr when != 0;
    # mutually exclusive with Q — models.make_metric).
    eps3: float = 0.0
    r_obs_mult: float = 100.0          # observer radius in units of M
    psi_y: float = 0.0                 # BH screen pitch offset [rad]
    psi_x: float = 0.0                 # BH screen yaw offset [rad]
    vertical_fov_deg: float = 40.0
    theta_obs: float = math.pi / 2     # observer inclination
    # Camera 3-velocity in units of c, camera coords (+x right, +y down,
    # +z forward); (0,0,0) = static observer (camera.aberrate_view).
    boost: tuple = (0.0, 0.0, 0.0)
    # User-defined spacetime (models.CustomMetric); when set, metric()
    # returns it in place of the (M, a, Q, eps3) family.
    custom_metric: object = None

    @property
    def psi(self):
        return (self.psi_y, self.psi_x)

    def metric(self):
        """The scene's Metric: the custom metric when one is set, else
        the (M, a, Q, eps3) family dispatch (models.make_metric)."""
        if self.custom_metric is not None:
            return self.custom_metric
        from light_path_tracer_tpu_torch.models import make_metric
        return make_metric(self.M, self.a, self.Q, self.eps3)

    @property
    def boosted(self) -> bool:
        return any(float(b) != 0.0 for b in self.boost)

    @property
    def r_obs(self) -> float:
        return self.r_obs_mult * self.M

    @property
    def vertical_fov(self) -> float:
        return math.radians(self.vertical_fov_deg)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Numerics + performance knobs."""

    dtype: str = "float32"             # "float32" | "float64"
    # Kerr integrator: "dp45" (Dormand-Prince 4(5)), "dop853" (Hairer's
    # 8(5,3)) or the fixed-step comparison "rk4" (ops/kerr_rk4.py).
    integrator: str = "dp45"
    # Only "auto": the tensor's device picks the path (CUDA -> the
    # hand-written kernel, CPU -> the plain PyTorch loop).
    backend: str = "auto"
    # Boundary-crossing interpolation of the shadow and lensed traces:
    # "hermite" (cubic, from the step's end derivatives) or "linear".
    event_interp: str = "hermite"
    # Polar-coordinate formulation of the Kerr trace: "theta" or "mu"
    # (mu = cos(theta), the transcendental-free RHS, with the rays near
    # the polar axis re-traced in theta: ops/batch.py, the hybrid tracer).
    formulation: str = "theta"
    # Tolerance tier: "fast" (f32 atol 3e-5), "precise" (f32 3e-6) or
    # "gate" (f32 1e-6; f64 1e-7) — ops/kerr_trace.py TOLS*.
    precision: str = "fast"
    # Background-texture sampling of the lensed render: "nearest" or
    # "bilinear".
    sampling: str = "nearest"
    max_steps: int = 200000            # adaptive-step bound per ray
    phi_max: float = 50.0              # Schwarzschild orbit bound
    h_max: float = 0.05                # Schwarzschild fixed step
    # None = one dispatch over the whole grid; else Kerr rays are traced
    # in chunks of this many (ops/batch.py).
    chunk_size: int | None = None
    sort_by_difficulty: bool = True    # chunked path only
    # Two-pass straggler retrace (ops/cuda/kerr_trace_kernel.py): "auto"
    # is on for batches above 2M rays and for every disk, volumetric and
    # spectral trace. pass1_steps caps the shadow and disk first pass (the
    # volumetric drivers keep the JAX package's 4096).
    two_pass: str | bool = "auto"
    pass1_steps: int = 512
    # Emission-saturation and frozen-state exits of the volumetric
    # family: attempts a ray may go without changing (0 = off).
    sat_window: int = 2048
    axis_refine_frac: float = 0.07     # tolerance-tightening column band
    use_tb_symmetry: bool = True       # top/bottom mirror when applicable
    render_loop_around: bool = False
    winding_max: int = 65535           # uint16 winding clip
    # Chunked-trace progress (chunked path only): False | True (tqdm) |
    # "live" (in-place ANSI bar with CPU% and RSS, utils/progress.py).
    progress: bool | str = False
