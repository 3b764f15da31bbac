"""Shared CLI plumbing: flag groups and scene/config construction, with
the JAX package's flag names and defaults."""

from __future__ import annotations

import numpy as np


def _add_scene_args(p):
    p.add_argument("--M", type=float, default=1.0, help="BH mass")
    p.add_argument("--a", type=float, default=0.0,
                   help="BH spin (|a| <= M; only Kerr, a != 0, is ported)")
    p.add_argument("--Q", type=float, default=0.0,
                   help="BH charge (not ported yet)")
    p.add_argument("--eps3", type=float, default=0.0,
                   help="Johannsen-Psaltis deformation (not ported yet)")
    p.add_argument("--r-obs", type=float, default=100.0,
                   help="Observer distance in units of M (default: 100)")
    p.add_argument("--psi-y", type=float, default=0.0,
                   help="BH vertical offset in deg (+ = top, - = bottom)")
    p.add_argument("--psi-x", type=float, default=0.0,
                   help="BH horizontal offset in deg (+ = right, - = left)")
    p.add_argument("--fov-v", type=float, default=40.0,
                   help="Vertical field of view in deg")
    p.add_argument("--theta-obs", type=float, default=90.0,
                   help="Observer inclination from the spin axis in deg "
                        "(default: 90 = equatorial)")
    p.add_argument("--boost", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   metavar=("BX", "BY", "BZ"),
                   help="camera 3-velocity in units of c (not ported yet)")


def _add_render_args(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device: 'cuda' runs the hand-written CUDA "
                        "kernel, 'cpu' the plain PyTorch loop")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="float64 runs on the CPU path only (the CUDA "
                        "kernel is float32)")
    p.add_argument("--chunk-size", type=int, default=0,
                   help="rays per chunk (0 = whole grid in one dispatch; "
                        "chunking is not ported yet)")
    p.add_argument("--no-symmetry", action="store_true",
                   help="disable top/bottom mirror symmetry")
    p.add_argument("--precision", default="fast",
                   choices=["fast", "precise", "gate"],
                   help="tolerance tier: fast (throughput), precise, or "
                        "gate (accuracy tier)")
    p.add_argument("--integrator", default="dp45",
                   choices=["dp45", "dop853", "rk4"],
                   help="Kerr integrator (only dp45 is ported)")
    p.add_argument("--max-steps", type=int, default=200000,
                   help="adaptive-step budget per ray")


def _scene_from(args):
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    return SceneConfig(
        M=args.M, a=args.a, Q=args.Q, eps3=args.eps3,
        r_obs_mult=args.r_obs,
        psi_y=float(np.radians(args.psi_y)),
        psi_x=float(np.radians(args.psi_x)),
        vertical_fov_deg=args.fov_v,
        theta_obs=float(np.radians(args.theta_obs)),
        boost=tuple(args.boost))


def _render_cfg_from(args):
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    return RenderConfig(
        dtype=args.dtype,
        max_steps=args.max_steps,
        chunk_size=args.chunk_size or None,
        use_tb_symmetry=not args.no_symmetry,
        precision=args.precision,
        integrator=args.integrator)
