"""`shadow` subcommand: analytic or integrated shadow render."""

from __future__ import annotations

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (
    _add_render_args, _add_scene_args, _render_cfg_from, _scene_from)


def cmd_shadow(args) -> int:
    """Shadow render (analytic threshold or integrated rays)."""
    from light_path_tracer_tpu_torch.pipeline import render_shadow
    from light_path_tracer_tpu_torch.utils.save import save_gray_png

    for flag, used in (("--aa", args.aa > 1), ("--rings", args.rings),
                       ("--multihost", args.multihost),
                       ("--visibility", args.visibility is not None)):
        if used:
            raise NotImplementedError(
                f"shadow {flag} is not ported to the PyTorch package yet "
                f"(ROADMAP.md, Queue 1)")

    scene = _scene_from(args)
    cfg = _render_cfg_from(args)
    img, stats = render_shadow(scene, (args.size, args.size), cfg,
                               analytic=args.analytic, device=args.device)
    save_gray_png(args.output, img)
    t = stats["timings"]
    mode = "analytic threshold" if args.analytic else "integrated"
    trace_t = t.get("precompute", 0.0)
    print(f"Shadow ({mode}): {args.size}x{args.size}, "
          f"alpha_crit={np.degrees(stats['alpha_crit']):.4f} deg, "
          f"precompute {trace_t:.3f}s, "
          f"render {t.get('render', 0.0):.3f}s")
    if stats.get("traced_rays"):
        print(f"  {stats['traced_rays'] / max(trace_t, 1e-12):,.0f} rays/s")
    print(f"Saved: {args.output}")
    return 0


def register(sub):
    p = sub.add_parser("shadow", help="black-hole shadow render")
    p.add_argument("--aa", type=int, default=1,
                   help="jittered AA samples per pixel (not ported yet)")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--analytic", action="store_true",
                   help="zero-integration threshold test vs alpha_crit")
    p.add_argument("--rings", action="store_true",
                   help="photon-ring decomposition (not ported yet)")
    p.add_argument("--output", default="black_hole_shadow.png")
    p.add_argument("--visibility", metavar="PATH",
                   help="visibility-domain analysis (not ported yet)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process render (not ported yet)")
    p.set_defaults(fn=cmd_shadow)
