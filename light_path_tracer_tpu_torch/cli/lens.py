"""`lens` subcommand: the lensed background-image render and its
map-level modes.

The renders of the JAX package's `lens`: load the image, print the
metric, alpha_crit and the BH's screen offset, `render_scene` (or with
`--aa N` `render_scene_aa`, with `--adaptive` too `render_scene_adaptive`;
with `--disk` the composite with an accretion disk, `render_scene_with_disk`
or with `--aa N` the stacked `render_scene_with_disk_aa`, blackbody disk
pixels display-encoded), save the PNG and print the benchmark summary;
`--rings` also writes the lensed image split by photon-ring order. The
map-level modes need no image: `--magnification`, `--shear`,
`--caustics`, `--time-delay` (PNG through utils/color.py's tables;
`--shear` one PNG a panel and an .npz of the maps), `--microlens` (a CSV)
and `--find-images` (a printed table). `--cache` keeps the traced tables
in `lookup_cache/` (checkpoint.cached_precompute; a re-render of the same
scene with another image skips the trace) and prints `lookup cache
HIT|MISS`. Every flag of the JAX parser is registered with its default;
`--multihost` raises NotImplementedError.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from light_path_tracer_tpu_torch.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args,
    _render_cfg_from, _scene_from, _stem, not_ported)


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

    if args.multihost:
        raise not_ported("lens --multihost")

    scene = _scene_from(args)
    cfg = _render_cfg_from(args)
    print(_metric_line(args))
    for flag, mode in _MODES:
        if getattr(args, flag) is not None:
            return mode(args, scene, cfg)

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

    ring_tables = None
    if args.disk:
        if args.cache:
            print("  note: --cache is not supported with --disk "
                  "(composite re-traces); ignoring")
        result, stats = _composite(args, scene, cfg, img)
        timings = stats["timings"]
        timings["load_image"] = timings.get("load_image", 0.0) + load_time
        total, traced = stats["total_rays"], stats["traced_rays"]
    elif args.cache:
        if args.aa > 1:
            print("  note: --aa is not supported with --cache "
                  "(the cache stores one non-jittered lookup); ignoring")
        result, timings, pre = _cached(args, scene, cfg, img, fov)
        timings["load_image"] += load_time
        total, traced = pre.total_rays, pre.traced_rays
        ring_tables = (pre.final_alpha, pre.winding)
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
        ring_tables = (out.precompute.final_alpha, out.precompute.winding)

    if args.rings:
        if ring_tables is None:
            print(f"  note: --rings is not supported with "
                  f"{'--disk' if args.disk else '--aa'}; ignoring")
        else:
            _ring_layers(args, ring_tables, result)

    t0 = time.perf_counter()
    save_png(args.output, result)
    timings["save_image"] = time.perf_counter() - t0
    timings["total"] = timings.get("total", 0.0) + timings["save_image"]

    print_benchmark_summary((height, width), alpha_crit, total, traced,
                            timings)
    print(f"Saved: {args.output}")
    return 0


def _cached(args, scene, cfg, img, fov):
    """The lensed render from the lookup cache's tables
    (checkpoint.cached_precompute) through render.render_lensed_image:
    (image, timings, PrecomputeResult)."""
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.checkpoint import cached_precompute
    from light_path_tracer_tpu_torch.pipeline import _source_tensor
    from light_path_tracer_tpu_torch.render import render_lensed_image
    from light_path_tracer_tpu_torch.utils.timing import StageTimer
    dim = tuple(img.shape[:2])
    timer = StageTimer(args.device)
    with timer.stage("load_image"):
        src = _source_tensor(img, args.device)
    with timer.stage("precompute"):
        pre, hit = cached_precompute(scene, cfg, dim, fov,
                                     device=args.device)
    print(f"  lookup cache {'HIT' if hit else 'MISS'}")
    with timer.stage("render"):
        theta_lookup = camera.build_theta_lookup(
            dim, fov, psi=scene.psi, dtype=pre.final_alpha.dtype,
            boost=scene.boost, device=args.device)
        lensed = render_lensed_image(
            src, None, pre.final_alpha, pre.winding, None, fov,
            cfg.render_loop_around, psi=scene.psi,
            theta_lookup=theta_lookup, sampling=cfg.sampling)
    return lensed, timer.finish(), pre


def _save_rgb(path, rgb):
    """Save an (H, W, 3) float RGB NumPy image in [0, 1] as a PNG."""
    from light_path_tracer_tpu_torch.utils.save import save_png
    save_png(path, np.asarray(rgb, np.float32))
    print(f"Saved: {path}")


def _timing_note(tt, second="render"):
    return (f"(precompute {tt.get('precompute', 0.0):.3f}s, "
            f"{second} {tt.get(second, 0.0):.3f}s)")


def _ring_layers(args, ring_tables, result):
    """Write the render split by photon-ring order from its own tables,
    one PNG a layer (label without underscores), and print the counts."""
    from light_path_tracer_tpu_torch.pipeline import lensed_ring_layers
    from light_path_tracer_tpu_torch.utils.save import save_png
    layers, order_pixels = lensed_ring_layers(
        ring_tables[0], ring_tables[1], result, max_order=args.max_order)
    for layer, label in zip(layers, order_pixels):
        save_png(_stem(args.output, f"_{label.replace('_', '')}.png"),
                 torch.clamp(layer, 0.0, 1.0))
    for label, count in order_pixels.items():
        print(f"  {label:<12} {count:>10,} px")


def _magnification(args, scene, cfg):
    from light_path_tracer_tpu_torch.pipeline import render_magnification
    from light_path_tracer_tpu_torch.render import magnification_display
    mu, st = render_magnification(scene, (args.size, args.size), cfg,
                                  device=args.device)
    print(f"Magnification map {args.size}x{args.size}: "
          f"|mu|_max={st['mu_abs_max']:.1f}, "
          f"{st['negative_parity_pixels']} odd-parity px, "
          f"{st['shadow_pixels']} shadow px {_timing_note(st['timings'])}")
    _save_rgb(args.magnification, magnification_display(mu))
    return 0


# The --shear panels: map, colour table, symmetric about 0.
_SHEAR_PANELS = (("kappa", "RdBu_r", True), ("gamma", "inferno", False),
                 ("gamma1", "RdBu_r", True), ("omega", "RdBu_r", True))


def _shear(args, scene, cfg):
    from light_path_tracer_tpu_torch.pipeline import render_shear
    from light_path_tracer_tpu_torch.utils.color import colormap
    maps, st = render_shear(scene, (args.size, args.size), cfg,
                            device=args.device)
    arrays = {k: v.cpu().numpy() for k, v in maps.items()}
    print(f"Shear decomposition {args.size}x{args.size}: "
          f"gamma_max={st['gamma_max']:.2f}, "
          f"|omega|_max={st['omega_abs_max']:.2e}, "
          f"{st['shadow_pixels']} shadow px {_timing_note(st['timings'])}")
    for key, table, sym in _SHEAR_PANELS:
        v = arrays[key]
        fin = np.isfinite(v)
        lim = (np.percentile(np.abs(v[fin]), 99.0) if fin.any() else 1.0
               ) or 1.0
        x = 0.5 * (v / lim + 1.0) if sym else v / lim
        rgb = colormap(table, np.where(fin, x, 0.0))
        rgb[~fin] = 0.0
        _save_rgb(_stem(args.shear, f"_{key}.png"), rgb)
    npz = _stem(args.shear, ".npz")
    np.savez(npz, **arrays)
    print(f"Saved: {npz}")
    return 0


def _caustics(args, scene, cfg):
    from light_path_tracer_tpu_torch.pipeline import render_caustics
    from light_path_tracer_tpu_torch.utils.color import colormap
    amap, _extent, st = render_caustics(scene, (args.size, args.size), cfg,
                                        bins=args.caustic_bins,
                                        device=args.device)
    disp = np.log10(1.0 + np.maximum(amap.cpu().numpy(), 0.0))
    lim = np.percentile(disp, 99.5) or 1.0
    print(f"Caustic map {args.caustic_bins}x{args.caustic_bins} "
          f"(traced {args.size}x{args.size}, beta_max "
          f"{np.degrees(st['beta_max']):.2f} deg): "
          f"A_max={st['A_max']:.1f}, far-field median "
          f"A={st['A_far_field']:.3f} {_timing_note(st['timings'])}")
    _save_rgb(args.caustics, colormap("inferno",
                                      np.clip(disp / lim, 0.0, 1.0)))
    return 0


def _time_delay(args, scene, cfg):
    from light_path_tracer_tpu_torch.pipeline import render_time_delay
    from light_path_tracer_tpu_torch.utils.color import colormap
    tau, st = render_time_delay(scene, (args.size, args.size), cfg,
                                device=args.device)
    tau_np = tau.cpu().numpy()
    disp = np.log10(1.0 + np.nan_to_num(tau_np, nan=0.0))
    lim = np.nanpercentile(disp, 99.5) or 1.0
    rgb = colormap("viridis", np.clip(disp / lim, 0.0, 1.0))
    rgb[~np.isfinite(tau_np)] = 0.0
    print(f"Arrival-time map {args.size}x{args.size}: "
          f"tau_max={st['tau_max']:.2f} M, {st['shadow_pixels']} shadow px "
          f"{_timing_note(st['timings'])}")
    _save_rgb(args.time_delay, rgb)
    return 0


def _find_images(args, scene, cfg):
    from light_path_tracer_tpu_torch.images import (find_point_images,
                                                    format_image_table)
    try:
        bx_deg, by_deg = (float(v) for v in args.find_images.split(","))
    except ValueError:
        print("--find-images expects BX,BY in degrees "
              f"(got {args.find_images!r})")
        return 2
    imgs, st = find_point_images(
        scene, (np.radians(bx_deg), np.radians(by_deg)),
        resolution=(args.size, args.size), cfg=cfg, device=args.device)
    tt = st["timings"]
    print(f"Images of point source at beta = ({bx_deg:.4f}, "
          f"{by_deg:.4f}) deg ({args.size}x{args.size} grid):")
    print(format_image_table(imgs, st))
    print(f"  (precompute {tt.get('precompute', 0.0):.3f}s, "
          f"refine {tt.get('refine', 0.0):.3f}s, "
          f"products {tt.get('products', 0.0):.3f}s)")
    return 0


def _microlens(args, scene, cfg):
    from light_path_tracer_tpu_torch.pipeline import render_microlens_curve
    u_axis, curve, st = render_microlens_curve(
        scene, (args.size, args.size), cfg, impact_u=args.track_impact,
        span_u=args.track_span, n_points=args.track_points,
        source_radius_u=args.source_radius, device=args.device)
    curve_np = curve.cpu().numpy()
    xs = np.linspace(-args.track_span, args.track_span, args.track_points)
    # No plot is drawn: a .png path gets the CSV beside it.
    path = (_stem(args.microlens, ".csv")
            if args.microlens.lower().endswith(".png") else args.microlens)
    with open(path, "w") as fh:
        fh.write("track_pos_thetaE,u,A\n")
        for x, uu, aa in zip(xs, u_axis, curve_np):
            fh.write(f"{x:.6f},{uu:.6f},{aa:.8f}\n")
    print(f"Microlensing curve ({args.track_points} points, "
          f"impact u0={args.track_impact}, source radius "
          f"{args.source_radius} theta_E, theta_E = "
          f"{np.degrees(st['theta_E']):.3f} deg): "
          f"A_peak={st['A_peak']:.4f}, baseline {st['A_baseline']:.4f}")
    print(f"Saved: {path}")
    return 0


# The map-level modes in the JAX CLI's order of precedence.
_MODES = (("magnification", _magnification), ("shear", _shear),
          ("caustics", _caustics), ("time_delay", _time_delay),
          ("find_images", _find_images), ("microlens", _microlens))


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
                   help="also write the lensed image split by photon-"
                        "ring order (direct / 1st lensed / n-th ring), "
                        "one PNG a layer")
    p.add_argument("--max-order", type=int, default=3)
    p.add_argument("--magnification", metavar="PATH",
                   help="instead of lensing an image, write the signed "
                        "magnification map (RdBu_r PNG; critical curves "
                        "at |mu| -> inf, mu < 0 parity-flipped images, "
                        "the shadow black); --size sets the grid")
    p.add_argument("--size", type=int, default=512,
                   help="grid size for the map-level modes")
    p.add_argument("--shear", metavar="PATH",
                   help="write the weak-lensing decomposition of the "
                        "traced lens map: one PNG a panel (PATH_kappa, "
                        "_gamma, _gamma1, _omega) and PATH.npz of the "
                        "maps; --size sets the grid")
    p.add_argument("--caustics", metavar="PATH",
                   help="instead of lensing an image, write the "
                        "source-plane magnification (caustic) map by "
                        "inverse ray shooting (inferno PNG); --size sets "
                        "the traced grid")
    p.add_argument("--caustic-bins", type=int, default=256,
                   help="source-plane bins per axis for --caustics")
    p.add_argument("--microlens", metavar="PATH",
                   help="write a microlensing light curve of a finite "
                        "source crossing the lens at --track-impact as "
                        "CSV (beside PATH as .csv when PATH is a .png)")
    p.add_argument("--track-impact", type=float, default=1.0)
    p.add_argument("--track-span", type=float, default=4.0)
    p.add_argument("--track-points", type=int, default=81)
    p.add_argument("--source-radius", type=float, default=0.3)
    p.add_argument("--time-delay", metavar="PATH",
                   help="write the Fermat arrival-time map (viridis "
                        "PNG; float64 recommended)")
    p.add_argument("--find-images", metavar="BX,BY",
                   help="solve for every image of a point source at "
                        "gnomonic sky position (BX, BY) degrees about "
                        "the BH and print positions, signed "
                        "magnifications, windings and relative delays")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_lens)
