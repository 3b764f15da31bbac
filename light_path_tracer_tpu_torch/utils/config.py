"""Unified scene/render configuration (stdlib only).

The same pair of frozen dataclasses as `light_path_tracer_tpu.utils.config`,
field for field, so a scene and its numerics knobs carry across the two
packages unchanged (`light_path_tracer_tpu_torch.convert`). The fields that
select code this package has not ported yet are kept, and the code they
reach raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Physics + camera scene description."""

    M: float = 1.0
    a: float = 0.0
    # Black-hole charge in units of M (Reissner-Nordstrom when != 0;
    # mutually exclusive with a != 0 — models.make_metric).
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
    # +z forward); (0,0,0) = static observer. Non-zero is not ported yet
    # (camera.py raises).
    boost: tuple = (0.0, 0.0, 0.0)
    # User-defined spacetime. Not ported yet: metric() raises when set.
    custom_metric: object = None

    @property
    def psi(self):
        return (self.psi_y, self.psi_x)

    def metric(self):
        """The scene's Metric: the (M, a, Q, eps3) family dispatch
        (models.make_metric)."""
        if self.custom_metric is not None:
            raise NotImplementedError(
                "custom metrics are not ported to the PyTorch package yet "
                "(ROADMAP.md, Queue 1)")
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
    # Kerr integrator: only "dp45" (Dormand-Prince 4(5)) is ported.
    integrator: str = "dp45"
    # Only "auto": the tensor's device picks the path (CUDA -> the
    # hand-written kernel, CPU -> the plain PyTorch loop).
    backend: str = "auto"
    # Boundary-crossing interpolation; only "hermite" is ported.
    event_interp: str = "hermite"
    # Polar-coordinate formulation; only "theta" is ported.
    formulation: str = "theta"
    # Tolerance tier: "fast" (f32 atol 3e-5), "precise" (f32 3e-6) or
    # "gate" (f32 1e-6; f64 1e-7) — ops/kerr_trace.py TOLS*.
    precision: str = "fast"
    # Background-texture sampling of the lensed render (not ported yet).
    sampling: str = "nearest"
    max_steps: int = 200000            # adaptive-step bound per ray
    phi_max: float = 50.0              # Schwarzschild orbit bound
    h_max: float = 0.05                # Schwarzschild fixed step
    # None = one dispatch over the whole grid (the only ported branch).
    chunk_size: int | None = None
    sort_by_difficulty: bool = True    # chunked path only
    # Two-pass straggler retrace: "auto" traces in one pass in this
    # package (the two-pass driver is not ported); True raises.
    two_pass: str | bool = "auto"
    pass1_steps: int = 512
    # Emission-saturation early exit of the volumetric family (not
    # ported yet).
    sat_window: int = 2048
    axis_refine_frac: float = 0.07     # tolerance-tightening column band
    use_tb_symmetry: bool = True       # top/bottom mirror when applicable
    render_loop_around: bool = False
    winding_max: int = 65535           # uint16 winding clip
    progress: bool | str = False       # chunked path only
