"""`lens` subcommand: the lensed background-image render.

The plain and AA renders of the JAX package's `lens`: load the image,
print the metric, alpha_crit and the BH's screen offset, `render_scene`
(or with `--aa N` `render_scene_aa`, with `--adaptive` too
`render_scene_adaptive`; with `--disk` the composite with an accretion
disk, `render_scene_with_disk` or with `--aa N` the stacked
`render_scene_with_disk_aa`, blackbody disk pixels display-encoded), save
the PNG and print the benchmark summary. Every flag of the JAX parser is
registered with its default; the modes not ported yet (lookup cache,
ring layers, the map-level products, multihost) raise
NotImplementedError.
"""

from __future__ import annotations

import time

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args,
    _render_cfg_from, _scene_from, not_ported)


def _metric_line(args) -> str:
    kind = ("Kerr-Newman" if args.a != 0 and args.Q != 0
            else "Kerr" if args.a != 0
            else "Reissner-Nordstrom" if args.Q != 0
            else "Schwarzschild")
    return (f"Metric: {kind} (M={args.M}, a={args.a}"
            + (f", Q={args.Q}" if args.Q else "") + ")")


def _composite(args, scene, cfg, img):
    """The lensed background with the accretion disk of the flags, the
    linear-light blackbody disk pixels display-encoded for the PNG."""
    from light_path_tracer_tpu_torch.disk import (
        DiskConfig, composite_gamma_encode, render_scene_with_disk,
        render_scene_with_disk_aa)
    disk = DiskConfig(r_out=args.r_out, emissivity_index=args.emissivity_q,
                      g_power=args.g_power, opaque=not args.translucent,
                      spectrum=args.spectrum, t_peak=args.t_peak)
    if args.adaptive:
        print("  note: --adaptive is not supported with --disk (the "
              "composite needs every pixel's crossing record); using "
              "stacked uniform AA")
    if args.aa > 1:
        # Each pass display-encoded before the average: exact AA in
        # display space.
        result, stats = render_scene_with_disk_aa(
            scene, img, cfg, disk, disk_gain=args.disk_gain,
            aa_samples=args.aa, display_encode=True, device=args.device)
    else:
        result, stats = render_scene_with_disk(
            scene, img, cfg, disk, disk_gain=args.disk_gain,
            device=args.device)
    if args.spectrum == "blackbody" and not stats.get("display_encoded"):
        result = composite_gamma_encode(result, stats["disk_mask"])
    print(f"  disk pixels: {stats['disk_pixels']:,}, "
          f"captured: {stats['captured']:,}, "
          f"r_isco={stats['r_isco']:.3f} M")
    return result, stats


def cmd_lens(args) -> int:
    """Lensed background-image render (image_lens.main parity)."""
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.pipeline import (
        print_benchmark_summary, render_scene)
    from light_path_tracer_tpu_torch.utils.save import read_png, save_png

    for flag, used in (
            ("--cache", args.cache),
            ("--rings", args.rings),
            ("--magnification", args.magnification is not None),
            ("--shear", args.shear is not None),
            ("--caustics", args.caustics is not None),
            ("--microlens", args.microlens is not None),
            ("--time-delay", args.time_delay is not None),
            ("--find-images", args.find_images is not None),
            ("--multihost", args.multihost)):
        if used:
            raise not_ported(f"lens {flag}")

    scene = _scene_from(args)
    cfg = _render_cfg_from(args)
    print(_metric_line(args))

    t0 = time.perf_counter()
    img = read_png(args.image)
    load_time = time.perf_counter() - t0
    height, width = img.shape[:2]
    print(f"Image: {width}x{height}")

    metric = scene.metric()
    alpha_crit = metric.alpha_crit(scene.r_obs, device=args.device)
    print(f"r_obs = {scene.r_obs:.1f} M, "
          f"alpha_crit = {np.degrees(alpha_crit):.4f} deg")

    bh_y, bh_x, in_front = camera.psi_to_cam_projection(scene.psi)
    fov = camera.fov_from_vertical(scene.vertical_fov, (height, width))
    in_fov = (in_front and abs(bh_y) <= np.tan(fov[1] / 2)
              and abs(bh_x) <= np.tan(fov[0] / 2))
    status = ("behind observer" if not in_front
              else ("inside FOV" if in_fov else "outside FOV"))
    print(f"BH screen offset: psi_y={args.psi_y:.4f} deg, "
          f"psi_x={args.psi_x:.4f} deg ({status})")

    if args.disk:
        result, stats = _composite(args, scene, cfg, img)
        timings = stats["timings"]
        timings["load_image"] = timings.get("load_image", 0.0) + load_time
        total, traced = stats["total_rays"], stats["traced_rays"]
    elif args.aa > 1:
        if args.adaptive:
            from light_path_tracer_tpu_torch.adaptive import (
                render_scene_adaptive)
            result, stats = render_scene_adaptive(
                scene, img, cfg, aa_samples=args.aa,
                refine_frac=args.refine_frac, device=args.device)
            print(f"  adaptive AA: {stats['refined_pixels']:,} pixels "
                  f"refined ({stats['edge_pixels']:,} discrete-edge), "
                  f"{stats['total_rays']:,} rays vs "
                  f"{stats['uniform_aa_rays']:,} uniform")
        else:
            from light_path_tracer_tpu_torch.aa import render_scene_aa
            result, stats = render_scene_aa(scene, img, cfg,
                                            aa_samples=args.aa,
                                            device=args.device)
        timings = stats["timings"]
        timings["load_image"] = timings.get("load_image", 0.0) + load_time
        total, traced = stats["total_rays"], stats["traced_rays"]
    else:
        out = render_scene(scene, img, cfg, device=args.device)
        timings = out.timings
        timings["load_image"] += load_time
        result = out.image
        total = out.precompute.total_rays
        traced = out.precompute.traced_rays

    t0 = time.perf_counter()
    save_png(args.output, result)
    timings["save_image"] = time.perf_counter() - t0
    timings["total"] = timings.get("total", 0.0) + timings["save_image"]

    print_benchmark_summary((height, width), alpha_crit, total, traced,
                            timings)
    print(f"Saved: {args.output}")
    return 0


def register(sub):
    p = sub.add_parser("lens", help="lensed background-image render")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--image", default="image.jpg",
                   help="background image (8-bit PNG)")
    p.add_argument("--output", default="lensed_image.png")
    p.add_argument("--disk", action="store_true",
                   help="composite an accretion disk over the lensed "
                        "image (one trace a pixel; with --aa N the "
                        "stacked AA composite)")
    p.add_argument("--r-out", type=float, default=20.0)
    p.add_argument("--emissivity-q", type=float, default=3.0)
    p.add_argument("--g-power", type=float, default=3.0)
    p.add_argument("--translucent", action="store_true")
    p.add_argument("--spectrum", default="blackbody",
                   choices=["powerlaw", "blackbody"])
    p.add_argument("--t-peak", type=float, default=9000.0)
    p.add_argument("--disk-gain", type=float, default=1.0,
                   help="disk brightness relative to the background")
    p.add_argument("--aa", type=int, default=1,
                   help="jittered AA samples per pixel")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive AA: refine only edge pixels at --aa "
                        "samples (adaptive.py)")
    p.add_argument("--refine-frac", type=float, default=0.05,
                   help="adaptive-AA refinement budget (fraction of "
                        "pixels, the highest edge scores)")
    p.add_argument("--rings", action="store_true",
                   help="photon-ring layers (not ported yet)")
    p.add_argument("--max-order", type=int, default=3)
    p.add_argument("--magnification", metavar="PATH",
                   help="magnification map (not ported yet)")
    p.add_argument("--size", type=int, default=512,
                   help="grid size for the map-level modes")
    p.add_argument("--shear", metavar="PATH",
                   help="weak-lensing decomposition (not ported yet)")
    p.add_argument("--caustics", metavar="PATH",
                   help="source-plane caustic map (not ported yet)")
    p.add_argument("--caustic-bins", type=int, default=256)
    p.add_argument("--microlens", metavar="PATH",
                   help="microlensing light curve (not ported yet)")
    p.add_argument("--track-impact", type=float, default=1.0)
    p.add_argument("--track-span", type=float, default=4.0)
    p.add_argument("--track-points", type=int, default=81)
    p.add_argument("--source-radius", type=float, default=0.3)
    p.add_argument("--time-delay", metavar="PATH",
                   help="Fermat arrival-time map (not ported yet)")
    p.add_argument("--find-images", metavar="BX,BY",
                   help="point-source image solver (not ported yet)")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_lens)
