"""`disk` subcommand: the accretion-disk render (BASELINE.json config 4),
and from one trace each: the polarized image, the polarized hot-spot Q-U
loop, the photon-ring decomposition, the emission-line profile, the
hot-spot light curve, the hot-spot frames and the jittered-AA render,
dispatched in the JAX package's order. Every flag of the JAX package's
`disk` is registered with its default. Pictures are written as PNG files
by this package's own writer (the frames as a numbered series), the
curves as the CSV columns the JAX package writes beside its plots, and
arrays as .npz; the GIF, the matplotlib plots and the EVPA tick overlay
are not drawn (the centroid report writes its CSV columns). Tilted,
warped and second disks, the boosted camera, the retarded-time light
curve and the visibility report run as in the JAX package; the
multi-host render is not ported yet and raises."""

from __future__ import annotations

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args,
    _centroid_report, _reject_metric_py, _render_cfg_from, _stem,
    _visibility_report, not_ported)


def _spot_times(args, scene, n):
    """The hot spot of the flags, its orbital period and n times over
    --orbits orbits (np.linspace, endpoint included)."""
    from light_path_tracer_tpu_torch.disk import HotSpot, keplerian_omega
    spot = HotSpot(r0=args.spot_r0, amplitude=args.spot_amplitude)
    period = abs(2.0 * np.pi / keplerian_omega(
        args.M, args.a, args.spot_r0, not args.retrograde, Q=scene.Q))
    return spot, period, np.linspace(0.0, period * args.orbits, n)


def _save_csv(plot_path, columns, header):
    path = _stem(plot_path, ".csv")
    np.savetxt(path, np.column_stack(columns), delimiter=",", header=header)
    return path


def _save_image(path, img, spectrum):
    from light_path_tracer_tpu_torch.utils.save import (save_afmhot_png,
                                                        save_gamma_png)
    if spectrum == "blackbody":
        save_gamma_png(path, img)
    else:
        save_afmhot_png(path, img)


def _polarization(args, scene, cfg, disk) -> int:
    import torch
    from light_path_tracer_tpu_torch.polarization import render_polarization
    from light_path_tracer_tpu_torch.utils.save import save_afmhot_png
    evpa, pol_frac, intensity, stats = render_polarization(
        scene, (args.size, args.size), cfg, disk, field=args.b_field,
        device=args.device)
    img = intensity / max(float(np.nanmax(intensity)), 1e-30)
    img = np.power(np.clip(img, 0.0, 1.0), 1 / 2.2)
    frac_path = _stem(args.polarization, "_pol_frac.png")
    npz_path = _stem(args.polarization, ".npz")
    save_afmhot_png(args.polarization, torch.from_numpy(
        img.astype(np.float32)))
    save_afmhot_png(frac_path, torch.from_numpy(
        np.clip(pol_frac, 0.0, 1.0).astype(np.float32)))
    np.savez(npz_path, evpa=evpa, pol_frac=pol_frac, intensity=intensity)
    t = stats["timings"]
    print(f"Polarization: {args.size}x{args.size}, a={args.a}, "
          f"{args.b_field} field, "
          f"{stats['polarized_pixels']:,} polarized px, "
          f"trace {t.get('precompute', 0.0):.3f}s")
    print(f"Saved: {args.polarization} (intensity), {frac_path}, "
          f"{npz_path} (evpa, pol_frac, intensity)")
    return 0


def _qu_loop(args, scene, cfg, disk) -> int:
    from light_path_tracer_tpu_torch.polarization import hotspot_qu_loop
    spot, period, ts = _spot_times(args, scene, max(args.frames, 48))
    t_arr, I, Q, U, stats = hotspot_qu_loop(
        scene, (args.size, args.size), ts, cfg, disk, spot,
        field=args.b_field, device=args.device)
    path = _save_csv(args.qu_loop, [t_arr, I, Q, U], "time_M,I,Q,U")
    tt = stats["timings"]
    print(f"Q-U loop: {len(ts)} samples over {args.orbits} orbit(s) "
          f"(period {period:.1f} M), {args.b_field} field, ONE trace "
          f"{tt.get('precompute', 0.0):.3f}s")
    print(f"Saved: {path}")
    return 0


def _decompose(args, scene, cfg, disk) -> int:
    import torch
    from light_path_tracer_tpu_torch.disk import (decomposed_display,
                                                  render_disk_decomposed)
    if args.aa > 1:
        print("  note: --aa is not supported with --decompose; ignoring")
    n_ord = max(args.orders, 2)
    names = ["composite"] + [f"n{k}" for k in range(n_ord)]
    paths = [_stem(args.decompose, f"_{name}.png") for name in names]
    layers, stats = render_disk_decomposed(
        scene, (args.size, args.size), cfg, disk, n_orders=n_ord,
        device=args.device)
    stack = torch.cat([layers.sum(dim=0)[None], layers])
    for path, im in zip(paths, decomposed_display(stack, disk.tone_map)):
        _save_image(path, im, disk.spectrum)
    npz_path = _stem(args.decompose, ".npz")
    np.savez(npz_path, layers=layers.cpu().numpy(),
             flux_per_order=np.asarray(stats["flux_per_order"]),
             mean_radius_rad=np.asarray(stats["mean_radius_rad"]),
             pixels_per_order=np.asarray(stats["pixels_per_order"]))
    flux = np.asarray(stats["flux_per_order"])
    frac = flux / max(flux.sum(), 1e-300)
    t = stats["timings"]
    print(f"Decomposition: {args.size}x{args.size}, a={args.a}, "
          f"{n_ord} orders from ONE trace "
          f"{t.get('precompute', 0.0):.3f}s")
    for k in range(n_ord):
        mr = np.degrees(stats["mean_radius_rad"][k])
        print(f"  n={k}: flux {frac[k]:.2%}, "
              f"{stats['pixels_per_order'][k]:,} px, "
              f"mean radius {mr:.3f} deg")
    print(f"  alpha_crit {np.degrees(stats['alpha_crit']):.3f} deg; "
          f"flux ratios {[f'{r:.3g}' for r in stats['flux_ratios']]}; "
          f"demagnification exponent(s) "
          f"{[f'{g:.2f}' for g in stats['gamma_estimates']]}")
    print(f"Saved: {paths[0]} .. {paths[-1]} + {npz_path}")
    return 0


def _line_profile(args, scene, cfg, disk) -> int:
    from light_path_tracer_tpu_torch.spectra import line_profile
    energy, flux, stats = line_profile(
        scene, (args.size, args.size), cfg, disk, n_bins=args.line_bins,
        rest_energy=args.rest_energy, aa_samples=max(args.aa, 1),
        device=args.device)
    path = _save_csv(args.line_profile, [energy, flux], "energy,flux")
    t = stats["timings"]
    seen = energy[flux > 0.01 * flux.max()]
    print(f"Line profile: a={args.a}, i={args.inclination} deg, "
          f"{stats['disk_pixels']:,} disk px, "
          f"E/E0 range {seen.min() / args.rest_energy:.3f}"
          f"-{seen.max() / args.rest_energy:.3f}, "
          f"trace {t.get('precompute', 0.0):.3f}s")
    print(f"Saved: {path}")
    return 0


def _light_curve(args, scene, cfg, disk) -> int:
    from light_path_tracer_tpu_torch.spectra import hotspot_light_curve
    spot, period, ts = _spot_times(args, scene, max(args.frames, 32))
    t_arr, flux, stats = hotspot_light_curve(
        scene, (args.size, args.size), ts, cfg, disk, spot,
        light_travel_delay=args.light_travel_delay, device=args.device)
    if args.light_travel_delay:
        print(f"  light-travel delay: {stats['delay_spread']:.1f} M "
              f"spread across the disk image")
    path = _save_csv(args.light_curve, [t_arr, flux], "time_M,flux")
    t = stats["timings"]
    print(f"Light curve: {len(ts)} samples over {args.orbits} orbit(s), "
          f"modulation x{flux.max() / flux.min():.2f}, ONE trace "
          f"{t.get('precompute', 0.0):.3f}s + "
          f"render {t.get('render', 0.0):.3f}s")
    print(f"Saved: {path}")
    return 0


def _frames(args, scene, cfg, disk) -> int:
    from light_path_tracer_tpu_torch.disk import render_disk_frames
    spot, period, _ts = _spot_times(args, scene, 1)
    times = [period * args.orbits * i / args.frames
             for i in range(args.frames)]
    paths = [_stem(args.output, f"_{k:03d}.png")
             for k in range(args.frames)]
    frames, stats = render_disk_frames(
        scene, (args.size, args.size), times, cfg, disk, spot,
        device=args.device)
    for path, frame in zip(paths, frames):
        _save_image(path, frame, disk.spectrum)
    npz_path = _stem(args.output, "_frames.npz")
    light_curve = stats["emission"].double().sum(dim=(1, 2)).cpu().numpy()
    np.savez(npz_path, times=np.asarray(times), light_curve=light_curve)
    t = stats["timings"]
    print(f"Hot-spot orbit: {args.frames} frames "
          f"({args.orbits} orbit(s), period {period:.1f} M), "
          f"ONE trace {t.get('precompute', 0.0):.3f}s + "
          f"render {t.get('render', 0.0):.3f}s")
    print(f"Saved: {paths[0]} .. {paths[-1]} + {npz_path}")
    if args.centroid:
        _centroid_report(args.centroid, scene, args.size,
                         stats["emission"], light_curve, args.spot_r0)
    return 0


def _disk2(args):
    """The second plane of --disk2, the first disk's emission model."""
    from light_path_tracer_tpu_torch.disk import DiskConfig
    return DiskConfig(
        r_in=args.disk2_r_in or None, r_out=args.disk2_r_out,
        emissivity_index=args.emissivity_q, g_power=args.g_power,
        opaque=not args.disk2_translucent, prograde=not args.retrograde,
        tilt=float(np.radians(args.disk2_tilt)),
        tilt_azimuth=float(np.radians(args.disk2_tilt_azimuth)),
        spectrum=args.spectrum, t_peak=args.t_peak)


def cmd_disk(args) -> int:
    """Accretion-disk render and its one-trace modes."""
    if _reject_metric_py(args, "disk"):
        return 2
    from light_path_tracer_tpu_torch.disk import (DiskConfig, render_disk,
                                                  render_disk_aa,
                                                  render_multi_disk)
    from light_path_tracer_tpu_torch.utils.config import SceneConfig

    if args.multihost:
        raise not_ported("disk --multihost")
    polarized = args.polarization or args.qu_loop
    if args.Q and polarized:
        print("  note: polarized rendering is Kerr-only; ignoring --Q")
    if args.visibility and (polarized or args.line_profile
                            or args.light_curve or args.frames > 1):
        print("  note: --visibility applies to the still disk image "
              "only; ignoring")
    if args.eps3:
        print("  note: disk mode is not wired for --eps3 (orbital "
              "dynamics are Kerr/charged closed forms); ignoring")
    scene = SceneConfig(
        M=args.M, a=args.a, Q=0.0 if polarized else args.Q,
        r_obs_mult=args.r_obs,
        psi_y=float(np.radians(args.psi_y)),
        psi_x=float(np.radians(args.psi_x)),
        vertical_fov_deg=args.fov_v,
        theta_obs=float(np.radians(args.inclination)),
        boost=tuple(args.boost))
    cfg = _render_cfg_from(args)
    disk = DiskConfig(r_out=args.r_out,
                      emissivity_index=args.emissivity_q,
                      g_power=args.g_power,
                      opaque=not args.translucent,
                      prograde=not args.retrograde,
                      tilt=float(np.radians(args.tilt)),
                      tilt_azimuth=float(np.radians(args.tilt_azimuth)),
                      warp_radius=args.warp_radius or None,
                      spectrum=args.spectrum, t_peak=args.t_peak)

    for flag, mode in ((args.polarization, _polarization),
                       (args.qu_loop, _qu_loop),
                       (args.decompose, _decompose),
                       (args.line_profile, _line_profile),
                       (args.light_curve, _light_curve),
                       (args.frames > 1, _frames)):
        if flag:
            return mode(args, scene, cfg, disk)

    if args.disk2:
        if args.aa > 1:
            print("  note: --aa is not supported with --disk2; ignoring")
        img, stats = render_multi_disk(scene, (args.size, args.size), cfg,
                                       [disk, _disk2(args)],
                                       device=args.device)
        print(f"  two disks: per-plane pixels "
              f"{stats['disk_pixels_per_plane']}")
    elif args.aa > 1:
        img, stats = render_disk_aa(scene, (args.size, args.size), cfg,
                                    disk, aa_samples=args.aa,
                                    device=args.device)
    else:
        img, stats = render_disk(scene, (args.size, args.size), cfg, disk,
                                 device=args.device)
    _save_image(args.output, img, args.spectrum)
    t = stats["timings"]
    charge = f", Q={args.Q}" if args.Q else ""
    print(f"Accretion disk: {args.size}x{args.size}, a={args.a}{charge}, "
          f"inclination {args.inclination} deg, "
          f"r_isco={stats['r_isco']:.3f} M")
    print(f"  disk pixels: {stats['disk_pixels']:,}, "
          f"captured: {stats['captured']:,}")
    trace_t = max(t.get("precompute", 1e-12), 1e-12)
    print(f"  precompute {t.get('precompute', 0.0):.3f}s "
          f"({stats['traced_rays'] / trace_t:,.0f} rays/s)")
    print(f"Saved: {args.output}")
    if args.visibility:
        from light_path_tracer_tpu_torch import camera
        fov = camera.fov_from_vertical(scene.vertical_fov,
                                       (args.size, args.size))
        _visibility_report(img, fov, args.visibility, model="ring")
    return 0


def register(sub):
    p = sub.add_parser("disk", help="accretion-disk render (redshift + "
                                    "Doppler beaming)")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--inclination", type=float, default=80.0,
                   help="observer inclination from the spin axis in deg")
    p.add_argument("--r-out", type=float, default=20.0)
    p.add_argument("--emissivity-q", type=float, default=3.0)
    p.add_argument("--g-power", type=float, default=3.0)
    p.add_argument("--translucent", action="store_true")
    p.add_argument("--retrograde", action="store_true",
                   help="retrograde disk orbits (ISCO moves out, "
                        "Doppler limb swaps)")
    p.add_argument("--tilt", type=float, default=0.0,
                   help="disk tilt from the equator [deg] (emitter model "
                        "approximate for tilted Kerr)")
    p.add_argument("--tilt-azimuth", type=float, default=0.0,
                   help="azimuth of the tilted disk's line of nodes [deg]")
    p.add_argument("--warp-radius", type=float, default=0.0,
                   help="Bardeen-Petterson warp radius [M] (0 = flat "
                        "plane)")
    p.add_argument("--spectrum", default="powerlaw",
                   choices=["powerlaw", "blackbody"],
                   help="powerlaw: grayscale g^p r^-q (afmhot colormap); "
                        "blackbody: physical Planck colors at "
                        "T_obs = g T(r)")
    p.add_argument("--t-peak", type=float, default=9000.0,
                   help="blackbody peak disk temperature [K]")
    p.add_argument("--frames", type=int, default=1,
                   help=">1: hot-spot orbit animation from one trace, "
                        "written as OUTPUT_000.png .. (a numbered PNG "
                        "series in place of the GIF) and OUTPUT_frames.npz "
                        "(times, light curve)")
    p.add_argument("--orbits", type=float, default=1.0,
                   help="number of spot orbits across the animation")
    p.add_argument("--spot-r0", type=float, default=6.0,
                   help="hot-spot orbit radius [M]")
    p.add_argument("--spot-amplitude", type=float, default=6.0)
    p.add_argument("--centroid", default=None, metavar="PLOT.png",
                   help="with --frames: the photocenter track and light "
                        "curve written as PLOT.csv (phase, x_arcsec, "
                        "y_arcsec, flux_over_mean; no plot is drawn)")
    p.add_argument("--fps", type=float, default=12.0,
                   help="GIF frame rate (unused: the frames are a PNG "
                        "series)")
    p.add_argument("--aa", type=int, default=1,
                   help="jittered AA samples per pixel (disk edges / "
                        "photon ring)")
    p.add_argument("--decompose", default=None, metavar="PANEL.png",
                   help="photon-ring decomposition from one trace: writes "
                        "PANEL_composite.png, PANEL_n0.png .. on a shared "
                        "tone map (PNGs in place of the matplotlib panel) "
                        "and PANEL.npz (layers, fluxes, mean radii, "
                        "pixels); prints per-order fluxes and the "
                        "demagnification exponents")
    p.add_argument("--orders", type=int, default=3,
                   help="image orders for --decompose (>= 2)")
    p.add_argument("--polarization", default=None, metavar="PLOT.png",
                   help="polarized disk image (Walker-Penrose transport; "
                        "BH-centered camera): writes the intensity to "
                        "PLOT.png, the polarization fraction to "
                        "PLOT_pol_frac.png and PLOT.npz (evpa, pol_frac, "
                        "intensity); no EVPA tick overlay is drawn")
    p.add_argument("--b-field", default="toroidal",
                   choices=["vertical", "toroidal", "radial"],
                   help="magnetic-field geometry for --polarization and "
                        "--qu-loop")
    p.add_argument("--qu-loop", default=None, metavar="PLOT.png",
                   help="polarized hot-spot flare: the integrated Stokes "
                        "(I, Q, U) over --orbits orbits written as "
                        "PLOT.csv (time_M,I,Q,U; no plot is drawn)")
    p.add_argument("--line-profile", default=None, metavar="PLOT.png",
                   help="relativistic emission-line profile (flux vs "
                        "observed energy) written as PLOT.csv "
                        "(energy,flux; no plot is drawn)")
    p.add_argument("--rest-energy", type=float, default=6.4,
                   help="line rest energy for --line-profile (6.4 = "
                        "Fe K-alpha in keV; 1.0 = profile in g)")
    p.add_argument("--line-bins", type=int, default=200,
                   help="energy bins for --line-profile")
    p.add_argument("--light-travel-delay", action="store_true",
                   help="with --light-curve: the spot at each pixel's "
                        "retarded time (the crossing-time recorder)")
    p.add_argument("--light-curve", default=None, metavar="PLOT.png",
                   help="orbiting hot-spot light curve (>= 32 samples or "
                        "--frames over --orbits orbits) written as "
                        "PLOT.csv (time_M,flux; no plot is drawn)")
    p.add_argument("--disk2", action="store_true",
                   help="second independent disk plane, traced in the "
                        "same integration")
    p.add_argument("--disk2-r-in", type=float, default=0.0,
                   help="second disk inner radius [M] (0 = ISCO)")
    p.add_argument("--disk2-r-out", type=float, default=30.0)
    p.add_argument("--disk2-tilt", type=float, default=25.0,
                   help="second disk tilt from the equator [deg]")
    p.add_argument("--disk2-tilt-azimuth", type=float, default=0.0)
    p.add_argument("--disk2-translucent", action="store_true")
    p.add_argument("--output", default="accretion_disk.png")
    p.add_argument("--visibility", metavar="PATH",
                   help="visibility-domain analysis of the still image: "
                        "|V| radial profile saved as .npz, first-null "
                        "ring diameter printed")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_disk)
