"""Command-line interface of the PyTorch/CUDA port.

Usage:
  python -m light_path_tracer_tpu_torch shadow --a 0.9 --size 1024 --output s.png
  python -m light_path_tracer_tpu_torch shadow --size 1024    # Schwarzschild
  python -m light_path_tracer_tpu_torch shadow --Q 0.6 --analytic
  python -m light_path_tracer_tpu_torch shadow --a 0.9 --size 64 --device cpu
  python -m light_path_tracer_tpu_torch lens --image src.png --output l.png
  python -m light_path_tracer_tpu_torch disk --a 0.9 --size 1024 --output d.png
  python -m light_path_tracer_tpu_torch disk --a 0.9 --size 64 --device cpu
  python -m light_path_tracer_tpu_torch volumetric --a 0.9 --theta-obs 80 --fov-v 16 --size 1024
  python -m light_path_tracer_tpu_torch volumetric --size 32 --device cpu --freqs 0.1,1,10
  python -m light_path_tracer_tpu_torch animate --a 0.9 --size 256 --frames 8 --output pan.gif
  python -m light_path_tracer_tpu_torch animate --a 0.9 --flyby 200:20 --boost-to 0.5 --size 256
  python -m light_path_tracer_tpu_torch pano --a 0.9 --grid-sky --height 512 --output p.png
  python -m light_path_tracer_tpu_torch star --size 256 --output star.png
  python -m light_path_tracer_tpu_torch star --pulse-profile 64 --light-travel-delay --size 128
  python -m light_path_tracer_tpu_torch ray --alpha-deg 8 --no-plot
  python -m light_path_tracer_tpu_torch plot --a 0.9 --angles 0,2,4,5.5,5.97,8
  python -m light_path_tracer_tpu_torch orbit --a 0.9 --peri 8 --apo 16 --no-plot
  python -m light_path_tracer_tpu_torch shadow --a 0.9 --size 1024 --integrator rk4
  python -m light_path_tracer_tpu_torch shadow --size 512 --metric-py examples/user_metric_torch.py:hayward
"""

from __future__ import annotations

import argparse

from light_path_tracer_tpu_torch.cli import (animate, disk, lens, pano,
                                             shadow, star, trajectory,
                                             volumetric)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="light_path_tracer_tpu_torch",
        description="General-relativistic ray tracer (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="command")
    animate.register(sub)
    disk.register(sub)
    lens.register(sub)
    pano.register(sub)
    shadow.register(sub)
    star.register(sub)
    volumetric.register(sub)
    trajectory.register_ray(sub)
    trajectory.register_plot(sub)
    trajectory.register_orbit(sub)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


__all__ = ["build_parser", "main"]
