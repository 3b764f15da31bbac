"""`star` subcommand: stellar-surface image and pulse profiles.

The JAX package's `star` (star.render_star, star.pulse_profile): the
afmhot surface image at --output; `--pulse-profile N` writes the N-phase
light curve as OUTPUT.npz (phases, flux) and its plot only where
matplotlib imports; `--visibility PATH` the raw brightness's |V| profile
(observables.py, the uniform-disk model).
"""

from __future__ import annotations

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (
    _add_render_args, _add_scene_args, _render_cfg_from, _scene_from,
    _visibility_report)


def _plot(png, phases, flux, star, omega, stats) -> bool:
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.plot(phases / (2.0 * np.pi), flux)
    ax.set_xlabel("rotation phase")
    ax.set_ylabel("flux / mean")
    ax.set_title(f"R={star.radius}M, Omega={omega:.3g}/M, "
                 f"modulation {stats['modulation']:.1%}")
    fig.savefig(png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def cmd_star(args) -> int:
    """Compact-star surface image / pulse profile (star.py): hot caps on
    a neutron-star surface."""
    from light_path_tracer_tpu_torch.star import (StarConfig, pulse_profile,
                                                  render_star)
    from light_path_tracer_tpu_torch.utils.save import save_afmhot_png

    scene = _scene_from(args)
    cfg = _render_cfg_from(args)
    spots = tuple(tuple(float(v) for v in s.split(",")) for s in
                  (args.spot or ["30,0,20,1.0"]))
    omega = args.omega
    if args.period:
        omega = 2.0 * np.pi / args.period
    star = StarConfig(radius=args.radius, omega=omega,
                      t_surface=args.t_surface, spots=spots,
                      g_power=args.g_power, limb_k=args.limb_k,
                      tone_map=args.tone_map)

    if args.pulse_profile:
        phases, flux, stats = pulse_profile(
            scene, cfg, star, n_phases=args.pulse_profile,
            resolution=(args.size, args.size),
            light_travel_delay=args.light_travel_delay, device=args.device)
        stem = args.output[:-4] if args.output.endswith(
            (".npz", ".png")) else args.output
        np.savez(stem + ".npz", phases=phases, flux=flux)
        plotted = _plot(stem + ".png", phases, flux, star, omega, stats)
        print(f"Pulse profile: {args.pulse_profile} phases, "
              f"modulation {stats['modulation']:.2%}, "
              f"{stats['captured']:,} surface px")
        print(f"Saved: {stem}.npz" + (f" + {stem}.png" if plotted else
                                      " (no plot: matplotlib is not "
                                      "installed)"))
        return 0

    img, stats = render_star(scene, (args.size, args.size), cfg, star,
                             phase=np.radians(args.phase_deg),
                             device=args.device)
    save_afmhot_png(args.output, img)
    t = stats["timings"]
    print(f"Star ({args.radius}M): {args.size}x{args.size}, "
          f"apparent radius "
          f"{np.degrees(stats['apparent_radius_rad']):.4f} deg, "
          f"precompute {t.get('precompute', 0.0):.3f}s, "
          f"render {t.get('render', 0.0):.3f}s")
    rate = stats["traced_rays"] / max(t.get("precompute", 0.0), 1e-9)
    print(f"  surface {stats['captured']:,} px, {rate:,.0f} rays/s")
    if getattr(args, "visibility", None):
        from light_path_tracer_tpu_torch import camera
        fov = camera.fov_from_vertical(scene.vertical_fov,
                                       (args.size, args.size))
        # The filled stellar disk matches the uniform-disk Bessel kernel
        # (first null at 1.22 lambda/D).
        _visibility_report(stats["brightness"], fov, args.visibility,
                           model="disk")
    print(f"Saved: {args.output}")
    return 0


def register(sub):
    p = sub.add_parser("star",
                       help="compact-star surface image / NICER-style "
                            "pulse profile (hot spots on a neutron-star "
                            "surface)")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--radius", type=float, default=5.0,
                   help="stellar surface radius [M] (must exceed the "
                        "horizon; < ~3.5M makes the WHOLE surface visible "
                        "at once)")
    p.add_argument("--omega", type=float, default=0.0,
                   help="rigid rotation angular velocity [c/M]")
    p.add_argument("--period", type=float, default=0.0,
                   help="rotation period [M] (alternative to --omega)")
    p.add_argument("--spot", action="append", metavar="COLAT,AZ,RAD,T",
                   help="hot spot: colatitude, azimuth, angular radius "
                        "[deg], temperature; repeatable (default "
                        "30,0,20,1.0)")
    p.add_argument("--t-surface", type=float, default=0.5,
                   help="background surface temperature")
    p.add_argument("--g-power", type=float, default=4.0,
                   help="redshift weight exponent (4 = bolometric)")
    p.add_argument("--limb-k", type=float, default=0.0,
                   help="cos^k limb darkening (0 = isotropic)")
    p.add_argument("--phase-deg", type=float, default=0.0,
                   help="rotation phase of the still image [deg]")
    p.add_argument("--pulse-profile", type=int, metavar="N",
                   help="compute an N-phase rotational light curve instead "
                        "of an image (one trace, the phases as tensor "
                        "operations); saves .npz (+ plot with matplotlib)")
    p.add_argument("--light-travel-delay", action="store_true",
                   help="evaluate each surface element at its retarded "
                        "phase (records coordinate time along every ray)")
    p.add_argument("--tone-map", default="linear",
                   choices=["linear", "sqrt", "asinh"])
    p.add_argument("--visibility", metavar="PATH",
                   help="save the baseline-domain |V| profile of the raw "
                        "brightness image as PATH (.npz) and print the "
                        "uniform-disk diameter recovered from the first "
                        "null")
    p.add_argument("--output", default="star.png")
    p.set_defaults(fn=cmd_star)
