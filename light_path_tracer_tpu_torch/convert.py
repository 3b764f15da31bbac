"""Carry the JAX package's state into this package.

The tracer has no weights: a scene, a render configuration and the
metric's parameters are its whole state. These functions read the JAX
package's frozen dataclasses field by field, as plain Python floats, ints
and strings, and build this package's objects from them. They import
nothing of JAX; any object with the same fields works.
"""

from __future__ import annotations

import dataclasses

from light_path_tracer_tpu_torch.models import make_metric
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig


def scene_from_jax(scene) -> SceneConfig:
    """light_path_tracer_tpu SceneConfig -> this package's SceneConfig."""
    if getattr(scene, "custom_metric", None) is not None:
        raise NotImplementedError(
            "custom metrics are not ported to the PyTorch package yet")
    return SceneConfig(
        M=float(scene.M), a=float(scene.a), Q=float(scene.Q),
        eps3=float(scene.eps3), r_obs_mult=float(scene.r_obs_mult),
        psi_y=float(scene.psi_y), psi_x=float(scene.psi_x),
        vertical_fov_deg=float(scene.vertical_fov_deg),
        theta_obs=float(scene.theta_obs),
        boost=tuple(float(b) for b in scene.boost))


def render_cfg_from_jax(cfg) -> RenderConfig:
    """light_path_tracer_tpu RenderConfig -> this package's RenderConfig.

    Every field carries over unchanged except `backend`: it names one of
    the JAX package's implementations ('xla', 'pallas'), while this
    package picks its path from the tensor's device, so it becomes
    'auto'.
    """
    values = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(RenderConfig)}
    values["backend"] = "auto"
    return RenderConfig(**values)


def metric_from_jax(metric):
    """light_path_tracer_tpu metric -> this package's metric, from its
    (M, a, Q, eps3) parameters; families not ported yet raise."""
    return make_metric(float(metric.M), float(getattr(metric, "a", 0.0)),
                       float(getattr(metric, "Q", 0.0)),
                       float(getattr(metric, "eps3", 0.0)))
