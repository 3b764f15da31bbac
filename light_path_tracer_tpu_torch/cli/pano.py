"""`pano` subcommand: 360-degree equirectangular panorama.

The JAX package's `pano` (pano.render_panorama): the procedural graticule
sky (`--grid-sky`, or when --image does not exist) or an 8-bit PNG source
through utils/save.read_png, `--height` rows (width 2 x height),
`--winding-overlay`; saves the PNG, prints the shadow's share of the sky
and the benchmark summary. JPEG input and `--multihost` raise
NotImplementedError, as in `lens`.
"""

from __future__ import annotations

import os

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args,
    _render_cfg_from, _scene_from, not_ported)


def cmd_pano(args) -> int:
    """360-degree equirectangular panorama render (pano.py)."""
    from light_path_tracer_tpu_torch.pano import grid_sky, render_panorama
    from light_path_tracer_tpu_torch.pipeline import print_benchmark_summary
    from light_path_tracer_tpu_torch.utils.save import read_png, save_png

    if args.multihost:
        raise not_ported("pano --multihost")
    scene = _scene_from(args)
    cfg = _render_cfg_from(args)
    if args.fov_v != 40.0:
        print("  note: the panorama chart covers the full sphere; "
              "--fov-v is ignored")

    if args.grid_sky or not os.path.exists(args.image):
        if not args.grid_sky:
            print(f"note: {args.image} not found; using the procedural "
                  f"graticule sky (--grid-sky)")
        h = args.height or 512
        sky = grid_sky((h, 2 * h))
    else:
        if not args.image.lower().endswith(".png"):
            raise not_ported(f"pano --image {args.image!r} (JPEG and other "
                             f"non-PNG input)")
        sky = read_png(args.image)
    resolution = (args.height, 2 * args.height) if args.height else None

    out = render_panorama(scene, sky, resolution=resolution, cfg=cfg,
                          winding_overlay=args.winding_overlay,
                          device=args.device)
    height, width = tuple(out.final_alpha.shape)
    save_png(args.output, out.image)
    cap = np.isnan(out.final_alpha.cpu().numpy())
    lat = np.pi / 2 - (np.arange(height) + 0.5) / height * np.pi
    wgt = np.broadcast_to(np.cos(lat)[:, None], (height, width))
    frac = float((cap * wgt).sum() / max(float(wgt.sum()), 1e-12))
    print(f"Panorama {height}x{width}: shadow covers {100 * frac:.2f}% "
          f"of the sky (alpha_crit envelope "
          f"{np.degrees(out.alpha_crit):.2f} deg)")
    print_benchmark_summary((height, width), out.alpha_crit,
                            out.total_rays, out.traced_rays, out.timings)
    print(f"Saved: {args.output}")
    return 0


def register(sub):
    p = sub.add_parser(
        "pano",
        help="360-degree equirectangular panorama render (VR skybox: the "
             "full lensed celestial sphere around the observer)")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--image", default="image.jpg",
                   help="equirectangular source sky (2:1 lat/lon chart, "
                        "8-bit PNG)")
    p.add_argument("--grid-sky", action="store_true",
                   help="use a procedural lat/lon graticule source sky "
                        "instead of --image")
    p.add_argument("--height", type=int, default=None,
                   help="output rows (width = 2*height); default: the "
                        "source sky's resolution")
    p.add_argument("--winding-overlay", action="store_true",
                   help="recolor photon-ring pixels (winding >= 1) with "
                        "the winding palette")
    p.add_argument("--output", default="pano.png")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_pano)
