"""Command-line interface of the PyTorch/CUDA port.

Usage:
  python -m light_path_tracer_tpu_torch shadow --a 0.9 --size 1024 --output s.png
  python -m light_path_tracer_tpu_torch shadow --a 0.9 --analytic
  python -m light_path_tracer_tpu_torch shadow --a 0.9 --size 64 --device cpu
"""

from __future__ import annotations

import argparse

from light_path_tracer_tpu_torch.cli import shadow


def build_parser():
    parser = argparse.ArgumentParser(
        prog="light_path_tracer_tpu_torch",
        description="General-relativistic ray tracer (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="command")
    shadow.register(sub)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


__all__ = ["build_parser", "main"]
