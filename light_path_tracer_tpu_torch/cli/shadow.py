"""`shadow` subcommand: analytic or integrated shadow render, with
uniform (`--aa N`) or adaptive (`--aa N --adaptive`) jittered AA, or the
photon-ring decomposition (`--rings`: the composite and one gray mask
PNG an order)."""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args,
    _render_cfg_from, _scene_from, _stem, _visibility_report, not_ported)


def _rings(args, scene, cfg):
    """The photon-ring decomposition: the composite at --output, each
    order's mask beside it (PATH_order0.png .. PATH_order{N}plus.png,
    PATH_shadow.png)."""
    from light_path_tracer_tpu_torch.pipeline import render_rings
    from light_path_tracer_tpu_torch.utils.save import (save_gray_png,
                                                        save_png)
    if args.visibility is not None:
        print("  note: --visibility is not supported with --rings; "
              "ignoring")
    masks, composite, stats = render_rings(
        scene, (args.size, args.size), cfg, max_order=args.max_order,
        device=args.device)
    save_png(args.output, composite)
    labels = ([f"order{k}" for k in range(args.max_order)]
              + [f"order{args.max_order}plus", "shadow"])
    for mask, label in zip(masks, labels):
        save_gray_png(_stem(args.output, f"_{label}.png"),
                      mask.to(torch.float32))
    t = stats["timings"]
    print(f"Photon-ring decomposition: {args.size}x{args.size}, "
          f"a={scene.a}, precompute {t.get('precompute', 0.0):.3f}s")
    for label, count in stats["order_pixels"].items():
        print(f"  {label:<12} {count:>10,} px")
    print(f"Saved: {args.output} (+ {len(labels)} per-order masks)")
    return 0


def cmd_shadow(args) -> int:
    """Shadow render (analytic threshold or integrated rays)."""
    from light_path_tracer_tpu_torch.pipeline import render_shadow
    from light_path_tracer_tpu_torch.utils.save import save_gray_png

    if args.multihost:
        raise not_ported("shadow --multihost")

    scene = _scene_from(args)
    cfg = _render_cfg_from(args)
    if args.rings:
        return _rings(args, scene, cfg)
    resolution = (args.size, args.size)
    if args.aa > 1:
        if args.analytic:
            print("  note: --aa applies to the integrated shadow; "
                  "ignoring --analytic")
        if args.adaptive:
            from light_path_tracer_tpu_torch.adaptive import (
                render_shadow_adaptive)
            img, stats = render_shadow_adaptive(
                scene, resolution, cfg, aa_samples=args.aa,
                refine_frac=args.refine_frac, device=args.device)
            print(f"  adaptive AA: {stats['refined_pixels']:,} pixels "
                  f"refined, {stats['total_rays']:,} rays vs "
                  f"{stats['uniform_aa_rays']:,} uniform")
        else:
            from light_path_tracer_tpu_torch.aa import render_shadow_aa
            img, stats = render_shadow_aa(scene, resolution, cfg,
                                          aa_samples=args.aa,
                                          device=args.device)
    else:
        img, stats = render_shadow(scene, resolution, cfg,
                                   analytic=args.analytic,
                                   device=args.device)
    save_gray_png(args.output, img)
    t = stats["timings"]
    mode = (f"integrated, {args.aa}x AA" if args.aa > 1
            else "analytic threshold" if args.analytic else "integrated")
    trace_t = t.get("precompute", 0.0)
    print(f"Shadow ({mode}): {args.size}x{args.size}, "
          f"alpha_crit={np.degrees(stats['alpha_crit']):.4f} deg, "
          f"precompute {trace_t:.3f}s, "
          f"render {t.get('render', 0.0):.3f}s")
    if stats.get("traced_rays"):
        print(f"  {stats['traced_rays'] / max(trace_t, 1e-12):,.0f} rays/s")
    print(f"Saved: {args.output}")
    if args.visibility is not None:
        from light_path_tracer_tpu_torch import camera
        fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
        # The silhouette (bright disk on dark sky) is the compact source
        # whose null encodes the shadow diameter.
        _visibility_report(1.0 - img, fov, args.visibility, model="disk",
                           true_diameter=2.0 * stats["alpha_crit"])
    return 0


def register(sub):
    p = sub.add_parser("shadow", help="black-hole shadow render")
    p.add_argument("--aa", type=int, default=1,
                   help="jittered AA samples per pixel (smooth shadow "
                        "boundary)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive AA: refine only shadow-boundary / "
                        "photon-ring pixels at --aa samples (adaptive.py)")
    p.add_argument("--refine-frac", type=float, default=0.05,
                   help="adaptive-AA refinement budget (fraction of "
                        "pixels, the highest edge scores)")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--analytic", action="store_true",
                   help="zero-integration threshold test vs alpha_crit")
    p.add_argument("--rings", action="store_true",
                   help="photon-ring decomposition (direct image, "
                        "1st lensed image, n-th photon ring): the "
                        "composite and one mask PNG an order")
    p.add_argument("--max-order", type=int, default=3,
                   help="highest photon-ring order to separate")
    p.add_argument("--output", default="black_hole_shadow.png")
    p.add_argument("--visibility", metavar="PATH",
                   help="visibility-domain analysis of the silhouette: "
                        "|V| radial profile saved as .npz, first-null "
                        "disk diameter printed against 2 alpha_crit")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_shadow)
