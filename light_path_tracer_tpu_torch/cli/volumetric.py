"""`volumetric` subcommand: the hot-flow still image (RIAF torus, power
law, shell or jet; optically thin or self-absorbed) and, with --freqs,
the multi-frequency spectral images from one trace. Every flag of the JAX
package's `volumetric` is registered with its default; the modes not
ported yet (movies, the order decomposition, polarization, the
visibility and centroid reports) raise."""

from __future__ import annotations

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (
    _add_render_args, _add_scene_args, _render_cfg_from, _scene_from,
    not_ported)


def _reject_unported(args):
    for flag, used in (("--movie", args.movie),
                       ("--decompose", args.decompose),
                       ("--polarization", args.polarization),
                       ("--visibility", args.visibility),
                       ("--centroid", args.centroid)):
        if used:
            raise not_ported(f"volumetric {flag}")


def _save_bands(path, images):
    """The band images side by side, 2 px apart, as one afmhot PNG."""
    from light_path_tracer_tpu_torch.utils.save import save_afmhot_png
    n, height, width = images.shape
    panel = images.new_zeros((height, n * width + 2 * (n - 1)))
    for i, img in enumerate(images):
        panel[:, i * (width + 2):i * (width + 2) + width] = img
    save_afmhot_png(path, panel)


def _spectrum(args, scene, cfg, riaf) -> int:
    from light_path_tracer_tpu_torch.volumetric import (
        render_volumetric_spectrum)
    freqs = tuple(float(f) for f in args.freqs.split(","))
    imgs, stats = render_volumetric_spectrum(
        scene, (args.size, args.size), freqs, cfg, riaf, device=args.device)
    _save_bands(args.output, imgs)
    base = args.output.rsplit(".", 1)[0]
    np.savez(base + "_spectrum.npz", freqs=stats["freqs"],
             flux=stats["flux"], mean_radius_rad=stats["mean_radius_rad"],
             spectral_index=np.stack(stats["spectral_index"])
             if stats["spectral_index"] else np.zeros(0))
    print(f"Spectral volumetric: {len(freqs)} bands in one trace "
          f"({stats['integrator_steps']:,} steps)")
    for f, fl, mr in zip(freqs, stats["flux"], stats["mean_radius_rad"]):
        print(f"  f={f:<6g} flux={fl:<12.4f} <r>={np.degrees(mr):.3f} deg")
    for i, amap in enumerate(stats["spectral_index"]):
        # Flux-weighted: dim outskirt pixels are thin at every band.
        w = np.where(np.isfinite(amap), stats["emission"][i], 0.0)
        mean_a = np.nansum(amap * w) / max(w.sum(), 1e-30)
        print(f"  alpha({freqs[i]:g}->{freqs[i + 1]:g}) flux-weighted "
              f"mean={mean_a:+.2f} (negative = rising/thick)")
    print(f"Saved: {args.output} + {base}_spectrum.npz")
    return 0


def cmd_volumetric(args) -> int:
    """Hot-flow render (volumetric.py): emission integrated along every
    geodesic."""
    from light_path_tracer_tpu_torch.utils.save import save_afmhot_png
    from light_path_tracer_tpu_torch.volumetric import (RIAFConfig,
                                                        render_volumetric)

    _reject_unported(args)
    scene = _scene_from(args)
    cfg = _render_cfg_from(args)
    # The blob only takes part in movies, which are not ported.
    riaf = RIAFConfig(
        profile=args.profile, r_peak=args.r_peak, sigma_r=args.sigma_r,
        h_cos=args.h_cos, index=args.index, shell_in=args.shell_in,
        shell_out=args.shell_out, g_power=args.g_power,
        prograde=not args.retrograde, tone_map=args.tone_map,
        alpha0=args.alpha0, opacity_index=args.opacity_index,
        spot_amp=0.0, spot_r=args.spot_r, spot_sigma=args.spot_sigma,
        jet_beta=args.jet_beta, jet_cos=args.jet_cos,
        jet_sigma=args.jet_sigma, jet_r_base=args.jet_r_base)
    if args.freqs:
        return _spectrum(args, scene, cfg, riaf)

    img, stats = render_volumetric(scene, (args.size, args.size), cfg, riaf,
                                   device=args.device)
    save_afmhot_png(args.output, img)
    t = stats["timings"]
    print(f"Volumetric ({args.profile}): {args.size}x{args.size}, "
          f"a={scene.a}, "
          f"alpha_crit={np.degrees(stats['alpha_crit']):.4f} deg, "
          f"precompute {t.get('precompute', 0.0):.3f}s, "
          f"render {t.get('render', 0.0):.3f}s")
    rate = stats["traced_rays"] / max(t.get("precompute", 0.0), 1e-9)
    print(f"  captured {stats['captured']:,} px, emission total "
          f"{stats['emission_total']:.3f}, {rate:,.0f} rays/s")
    if args.alpha0 > 0.0:
        print(f"  self-absorbed: alpha0={args.alpha0}, "
              f"max optical depth {stats['tau_max']:.2f}")
    print(f"Saved: {args.output}")
    return 0


def register(sub):
    p = sub.add_parser("volumetric",
                       help="hot-flow render (RIAF torus: the M87*-style "
                            "crescent image)")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--profile", default="torus",
                   choices=["torus", "powerlaw", "shell", "jet"],
                   help="rest-frame emissivity: Gaussian torus, power law "
                        "with a Gaussian scale height, spherical shell, or "
                        "bipolar jet funnel with a radial outflow "
                        "(--jet-beta)")
    p.add_argument("--jet-beta", type=float, default=0.0,
                   help="jet ZAMO-frame outflow speed in c")
    p.add_argument("--jet-cos", type=float, default=0.9,
                   help="jet cone center in |cos theta|")
    p.add_argument("--jet-sigma", type=float, default=0.06,
                   help="jet cone thickness in |cos theta|")
    p.add_argument("--jet-r-base", type=float, default=2.0,
                   help="jet emission base radius [M]")
    p.add_argument("--r-peak", type=float, default=4.5,
                   help="torus center / power-law pivot radius [M]")
    p.add_argument("--sigma-r", type=float, default=1.5,
                   help="torus radial Gaussian width [M]")
    p.add_argument("--h-cos", type=float, default=0.3,
                   help="vertical Gaussian width in cos(theta)")
    p.add_argument("--index", type=float, default=-1.5,
                   help="power-law emissivity exponent")
    p.add_argument("--shell-in", type=float, default=6.0,
                   help="shell inner radius [M] (--profile shell)")
    p.add_argument("--shell-out", type=float, default=10.0,
                   help="shell outer radius [M] (--profile shell)")
    p.add_argument("--g-power", type=float, default=3.0,
                   help="redshift weight exponent p in g^p j (3 = I_nu "
                        "invariance; 0 = pure path length)")
    p.add_argument("--retrograde", action="store_true",
                   help="reverse the flow rotation (flips the Doppler "
                        "crescent)")
    p.add_argument("--tone-map", default="sqrt",
                   choices=["linear", "sqrt", "asinh"])
    p.add_argument("--alpha0", type=float, default=0.0,
                   help="opacity scale [1/M] at the fiducial frequency "
                        "(rest-frame absorption alpha0 j); 0 = optically "
                        "thin")
    p.add_argument("--freqs", metavar="F1,F2,...",
                   help="multi-frequency mode: observed frequencies (units "
                        "of the fiducial), all bands in one trace; saves "
                        "the bands side by side and the SED (.npz)")
    p.add_argument("--opacity-index", type=float, default=0.0,
                   help="q in alpha_nu ~ nu^-q (0 = gray); with --freqs "
                        "it makes the photosphere frequency-dependent")
    p.add_argument("--movie", type=int, metavar="N",
                   help="flare movie of N frames (not ported yet)")
    p.add_argument("--orbits", type=float, default=1.0,
                   help="blob orbits covered by the movie")
    p.add_argument("--spot-amp", type=float, default=5.0,
                   help="blob peak emissivity (movie mode)")
    p.add_argument("--spot-r", type=float, default=6.0,
                   help="blob orbit radius [M]")
    p.add_argument("--centroid", default=None, metavar="PLOT.png",
                   help="with --movie: photocenter track (not ported yet)")
    p.add_argument("--decompose", default=None, metavar="PANEL.png",
                   help="photon-ring order decomposition (not ported yet)")
    p.add_argument("--orders", type=int, default=3,
                   help="image orders for --decompose (>= 2)")
    p.add_argument("--spot-sigma", type=float, default=1.0,
                   help="blob Gaussian size [M]")
    p.add_argument("--fps", type=float, default=12.0,
                   help="movie GIF frame rate")
    p.add_argument("--polarization", default=None, metavar="PLOT.png",
                   help="polarized volumetric image (not ported yet)")
    p.add_argument("--b-field", default="toroidal",
                   choices=["vertical", "toroidal", "radial"],
                   help="magnetic-field geometry for --polarization")
    p.add_argument("--output", default="volumetric.png")
    p.add_argument("--visibility", metavar="PATH",
                   help="baseline-domain |V| profile (not ported yet)")
    p.set_defaults(fn=cmd_volumetric)
