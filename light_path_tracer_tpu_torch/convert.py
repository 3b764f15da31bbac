"""Carry the JAX package's state into this package.

The tracer has no weights: a scene, a render configuration, a disk, hot
spot, hot-flow or stellar-surface configuration and the metric's parameters are its whole
state. These functions read the JAX
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


def disk_config_from_jax(disk):
    """light_path_tracer_tpu.disk.DiskConfig -> this package's
    DiskConfig, field by field."""
    from light_path_tracer_tpu_torch.disk import DiskConfig
    return DiskConfig(**{f.name: getattr(disk, f.name)
                         for f in dataclasses.fields(DiskConfig)})


def hotspot_from_jax(spot):
    """light_path_tracer_tpu.disk.HotSpot -> this package's HotSpot,
    field by field."""
    from light_path_tracer_tpu_torch.disk import HotSpot
    return HotSpot(**{f.name: float(getattr(spot, f.name))
                      for f in dataclasses.fields(HotSpot)})


def riaf_config_from_jax(riaf):
    """light_path_tracer_tpu.volumetric.RIAFConfig -> this package's
    RIAFConfig, field by field."""
    from light_path_tracer_tpu_torch.volumetric import RIAFConfig
    return RIAFConfig(**{f.name: getattr(riaf, f.name)
                         for f in dataclasses.fields(RIAFConfig)})


def star_config_from_jax(star):
    """light_path_tracer_tpu.star.StarConfig -> this package's StarConfig,
    field by field (the spots as tuples of floats)."""
    from light_path_tracer_tpu_torch.star import StarConfig
    values = {f.name: getattr(star, f.name)
              for f in dataclasses.fields(StarConfig)}
    values["spots"] = tuple(tuple(float(v) for v in spot)
                            for spot in values["spots"])
    return StarConfig(**values)


def metric_from_jax(metric):
    """light_path_tracer_tpu metric -> this package's metric, with the
    same floats. A Kerr-Newman or Johannsen-Psaltis instance keeps its
    class (the JAX package builds Kerr-Newman at a = 0 for charged disks,
    which make_metric would read as Reissner-Nordstrom); any other
    family goes through make_metric from its (M, a, Q, eps3)."""
    from light_path_tracer_tpu_torch.models import (JohannsenPsaltis,
                                                    KerrNewman)
    M, a = float(metric.M), float(getattr(metric, "a", 0.0))
    kind = type(metric).__name__
    if kind == "KerrNewman":
        return KerrNewman(M=M, a=a, Q=float(metric.Q))
    if kind == "JohannsenPsaltis":
        return JohannsenPsaltis(M=M, a=a, eps3=float(metric.eps3))
    return make_metric(M, a, float(getattr(metric, "Q", 0.0)),
                       float(getattr(metric, "eps3", 0.0)))
