"""Parser assembly and entry point."""

from __future__ import annotations

import argparse
import sys

from light_path_tracer_tpu_torch.cli import (animate, disk, lens, pano,
                                             request, shadow, star,
                                             trajectory, volumetric)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="light_path_tracer_tpu_torch",
        description="General-relativistic ray tracer (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="command")
    # Registration order = help-listing order, the JAX package's.
    lens.register(sub)
    shadow.register(sub)
    disk.register(sub)
    volumetric.register(sub)
    star.register(sub)
    pano.register(sub)
    animate.register(sub)
    trajectory.register_ray(sub)
    request.register(sub)
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


if __name__ == "__main__":
    sys.exit(main())
