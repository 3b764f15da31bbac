"""`disk` subcommand: the accretion-disk still render (BASELINE.json
config 4). Every flag of the JAX package's `disk` is registered with its
default; the modes not ported yet raise."""

from __future__ import annotations

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args,
    _render_cfg_from, not_ported)


def _reject_unported(args):
    for flag, used in (("--frames", args.frames > 1), ("--aa", args.aa > 1),
                       ("--decompose", args.decompose),
                       ("--polarization", args.polarization),
                       ("--qu-loop", args.qu_loop),
                       ("--line-profile", args.line_profile),
                       ("--light-curve", args.light_curve),
                       ("--disk2", args.disk2),
                       ("--multihost", args.multihost),
                       ("--visibility", args.visibility),
                       ("--centroid", args.centroid),
                       ("--tilt", args.tilt != 0.0),
                       ("--warp-radius", args.warp_radius != 0.0),
                       ("--boost", any(b != 0.0 for b in args.boost))):
        if used:
            raise not_ported(f"disk {flag}")


def cmd_disk(args) -> int:
    """Accretion-disk render."""
    from light_path_tracer_tpu_torch.disk import DiskConfig, render_disk
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    from light_path_tracer_tpu_torch.utils.save import (save_afmhot_png,
                                                        save_gamma_png)

    _reject_unported(args)
    if args.eps3:
        print("  note: disk mode is not wired for --eps3 (orbital "
              "dynamics are Kerr/charged closed forms); ignoring")
    scene = SceneConfig(
        M=args.M, a=args.a, Q=args.Q, r_obs_mult=args.r_obs,
        psi_y=float(np.radians(args.psi_y)),
        psi_x=float(np.radians(args.psi_x)),
        vertical_fov_deg=args.fov_v,
        theta_obs=float(np.radians(args.inclination)))
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

    img, stats = render_disk(scene, (args.size, args.size), cfg, disk,
                             device=args.device)
    if args.spectrum == "blackbody":
        save_gamma_png(args.output, img)
    else:
        save_afmhot_png(args.output, img)
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
                   help="disk tilt from the equator [deg] (not ported yet)")
    p.add_argument("--tilt-azimuth", type=float, default=0.0,
                   help="azimuth of the tilted disk's line of nodes [deg]")
    p.add_argument("--warp-radius", type=float, default=0.0,
                   help="Bardeen-Petterson warp radius [M] (not ported "
                        "yet; 0 = flat plane)")
    p.add_argument("--spectrum", default="powerlaw",
                   choices=["powerlaw", "blackbody"],
                   help="powerlaw: grayscale g^p r^-q (afmhot colormap); "
                        "blackbody: physical Planck colors at "
                        "T_obs = g T(r)")
    p.add_argument("--t-peak", type=float, default=9000.0,
                   help="blackbody peak disk temperature [K]")
    p.add_argument("--frames", type=int, default=1,
                   help=">1: hot-spot orbit animation (not ported yet)")
    p.add_argument("--orbits", type=float, default=1.0,
                   help="number of spot orbits across the animation")
    p.add_argument("--spot-r0", type=float, default=6.0,
                   help="hot-spot orbit radius [M]")
    p.add_argument("--spot-amplitude", type=float, default=6.0)
    p.add_argument("--centroid", default=None, metavar="PLOT.png",
                   help="with --frames: photocenter track (not ported "
                        "yet)")
    p.add_argument("--fps", type=float, default=12.0)
    p.add_argument("--aa", type=int, default=1,
                   help="jittered AA samples per pixel (not ported yet)")
    p.add_argument("--decompose", default=None, metavar="PANEL.png",
                   help="photon-ring decomposition (not ported yet)")
    p.add_argument("--orders", type=int, default=3,
                   help="image orders for --decompose (>= 2)")
    p.add_argument("--polarization", default=None, metavar="PLOT.png",
                   help="polarized disk image (not ported yet)")
    p.add_argument("--b-field", default="toroidal",
                   choices=["vertical", "toroidal", "radial"],
                   help="magnetic-field geometry for --polarization")
    p.add_argument("--qu-loop", default=None, metavar="PLOT.png",
                   help="polarized hot-spot Q-U loop (not ported yet)")
    p.add_argument("--line-profile", default=None, metavar="PLOT.png",
                   help="relativistic emission-line profile (not ported "
                        "yet)")
    p.add_argument("--rest-energy", type=float, default=6.4,
                   help="line rest energy for --line-profile")
    p.add_argument("--line-bins", type=int, default=200,
                   help="energy bins for --line-profile")
    p.add_argument("--light-travel-delay", action="store_true",
                   help="with --light-curve: retarded-time spot")
    p.add_argument("--light-curve", default=None, metavar="PLOT.png",
                   help="hot-spot light curve (not ported yet)")
    p.add_argument("--disk2", action="store_true",
                   help="second independent disk plane (not ported yet)")
    p.add_argument("--disk2-r-in", type=float, default=0.0,
                   help="second disk inner radius [M] (0 = ISCO)")
    p.add_argument("--disk2-r-out", type=float, default=30.0)
    p.add_argument("--disk2-tilt", type=float, default=25.0,
                   help="second disk tilt from the equator [deg]")
    p.add_argument("--disk2-tilt-azimuth", type=float, default=0.0)
    p.add_argument("--disk2-translucent", action="store_true")
    p.add_argument("--output", default="accretion_disk.png")
    p.add_argument("--visibility", metavar="PATH",
                   help="visibility-domain analysis (not ported yet)")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_disk)
