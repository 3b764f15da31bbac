"""`volumetric` subcommand: the hot-flow still image (RIAF torus, power
law, shell or jet; optically thin or self-absorbed); with --freqs the
multi-frequency spectral images, with --movie the flare-movie frames, with
--decompose the photon-ring order layers and with --polarization the
Stokes maps, each from one trace. Every flag of the JAX package's
`volumetric` is registered with its default. Pictures are written as PNG
files by this package's own writer and the arrays as .npz; the animated
GIF, the matplotlib panels and the EVPA tick overlay of the JAX package
are not drawn; the centroid report writes its CSV columns and the
visibility report its .npz profile."""

from __future__ import annotations

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (
    _add_render_args, _add_scene_args, _centroid_report, _render_cfg_from,
    _scene_from, _stem, _visibility_report)


def _polarization(args, scene, cfg, riaf) -> int:
    import torch
    from light_path_tracer_tpu_torch.polarization import (
        render_polarized_volumetric)
    from light_path_tracer_tpu_torch.utils.save import save_afmhot_png
    evpa, pol_frac, intensity, stats = render_polarized_volumetric(
        scene, (args.size, args.size), cfg, riaf, field=args.b_field,
        device=args.device)
    img = intensity / max(float(np.nanmax(intensity)), 1e-30)
    img = np.power(np.clip(img, 0.0, 1.0), 1 / 2.2)
    frac_path = _stem(args.polarization, "_pol_frac.png")
    npz_path = _stem(args.polarization, ".npz")
    save_afmhot_png(args.polarization, torch.from_numpy(
        img.astype(np.float32)))
    save_afmhot_png(frac_path, torch.from_numpy(
        np.clip(pol_frac, 0.0, 1.0).astype(np.float32)))
    np.savez(npz_path, evpa=evpa, pol_frac=pol_frac, I=stats["I"],
             Q=stats["Q"], U=stats["U"])
    sel = np.isfinite(evpa)
    print(f"Polarized volumetric ({args.b_field}): "
          f"{args.size}x{args.size}, {stats['integrator_steps']:,} steps, "
          f"mean pol fraction {np.nanmean(pol_frac[sel]):.3f} over "
          f"{int(sel.sum()):,} px")
    print(f"Saved: {args.polarization} (intensity), {frac_path}, "
          f"{npz_path} (evpa, pol_frac, I, Q, U)")
    return 0


def _movie(args, scene, cfg, riaf) -> int:
    from light_path_tracer_tpu_torch.disk import keplerian_omega
    from light_path_tracer_tpu_torch.utils.save import save_afmhot_png
    from light_path_tracer_tpu_torch.volumetric import (
        render_volumetric_movie)
    period = abs(2.0 * np.pi / keplerian_omega(
        scene.M, scene.a, args.spot_r, not args.retrograde, Q=scene.Q))
    times = tuple(period * args.orbits * k / args.movie
                  for k in range(args.movie))
    paths = [_stem(args.output, f"_{k:03d}.png") for k in range(args.movie)]
    frames, stats = render_volumetric_movie(
        scene, (args.size, args.size), times, cfg, riaf, device=args.device)
    for path, frame in zip(paths, frames):
        save_afmhot_png(path, frame)
    npz_path = _stem(args.output, "_movie.npz")
    np.savez(npz_path, times=stats["times"],
             light_curve=stats["light_curve"], emission=stats["emission"])
    t = stats["timings"]
    print(f"Flare movie: {args.movie} frames ({args.orbits} orbit(s), "
          f"period {period:.1f} M) from ONE trace "
          f"({stats['integrator_steps']:,} steps, "
          f"{t.get('precompute', 0.0):.3f}s)")
    lc = stats["light_curve"]
    print(f"  light curve modulation "
          f"{(lc.max() - lc.min()) / (lc.max() + lc.min()):.1%}, "
          f"retarded-time span {stats['t_max']:.0f} M")
    print(f"Saved: {paths[0]} .. {paths[-1]} + {npz_path}")
    if args.centroid:
        _centroid_report(args.centroid, scene, args.size,
                         stats["emission"], lc, args.spot_r)
    return 0


def _decompose(args, scene, cfg, riaf) -> int:
    import torch
    from light_path_tracer_tpu_torch.disk import decomposed_display
    from light_path_tracer_tpu_torch.utils.save import save_afmhot_png
    from light_path_tracer_tpu_torch.volumetric import (
        render_volumetric_decomposed)
    n_ord = max(args.orders, 2)
    names = ["composite"] + [f"n{k}" for k in range(n_ord)]
    paths = [_stem(args.decompose, f"_{name}.png") for name in names]
    layers, stats = render_volumetric_decomposed(
        scene, (args.size, args.size), cfg, riaf, n_orders=n_ord,
        device=args.device)
    stack = torch.cat([layers.sum(dim=0)[None], layers])
    for path, im in zip(paths, decomposed_display(stack, riaf.tone_map)):
        save_afmhot_png(path, im)
    npz_path = _stem(args.decompose, ".npz")
    np.savez(npz_path, layers=layers.cpu().numpy(),
             flux_per_order=np.asarray(stats["flux_per_order"]),
             mean_radius_rad=np.asarray(stats["mean_radius_rad"]),
             winding=stats["winding"])
    flux = np.asarray(stats["flux_per_order"])
    frac = flux / max(flux.sum(), 1e-300)
    t = stats["timings"]
    print(f"Decomposition: {args.size}x{args.size}, a={args.a}, "
          f"{n_ord} orders from ONE trace "
          f"({stats['integrator_steps']:,} steps, "
          f"{t.get('precompute', 0.0):.3f}s)")
    for k in range(n_ord):
        mr = np.degrees(stats["mean_radius_rad"][k])
        print(f"  n={k}: flux {frac[k]:.2%}, mean radius {mr:.3f} deg")
    print(f"  alpha_crit {np.degrees(stats['alpha_crit']):.3f} deg; "
          f"flux ratios {[f'{r:.3g}' for r in stats['flux_ratios']]}; "
          f"demagnification exponent(s) "
          f"{[f'{g:.2f}' for g in stats['gamma_estimates']]}")
    print(f"Saved: {paths[0]} .. {paths[-1]} + {npz_path}")
    return 0


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

    scene = _scene_from(args)
    cfg = _render_cfg_from(args)
    # The blob only takes part in movies (the still and spectral
    # emissivities are stationary).
    riaf = RIAFConfig(
        profile=args.profile, r_peak=args.r_peak, sigma_r=args.sigma_r,
        h_cos=args.h_cos, index=args.index, shell_in=args.shell_in,
        shell_out=args.shell_out, g_power=args.g_power,
        prograde=not args.retrograde, tone_map=args.tone_map,
        alpha0=args.alpha0, opacity_index=args.opacity_index,
        spot_amp=args.spot_amp if args.movie else 0.0,
        spot_r=args.spot_r, spot_sigma=args.spot_sigma,
        jet_beta=args.jet_beta, jet_cos=args.jet_cos,
        jet_sigma=args.jet_sigma, jet_r_base=args.jet_r_base)
    if args.polarization:
        return _polarization(args, scene, cfg, riaf)
    if args.movie:
        return _movie(args, scene, cfg, riaf)
    if args.decompose:
        return _decompose(args, scene, cfg, riaf)
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
    if args.visibility:
        from light_path_tracer_tpu_torch import camera
        fov = camera.fov_from_vertical(scene.vertical_fov,
                                       (args.size, args.size))
        # The raw intensity, not the tone-mapped image, is what an
        # interferometer measures.
        _visibility_report(stats["emission"], fov, args.visibility,
                           model="ring")
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
                   help="flare movie: N observer-time frames of an "
                        "orbiting hot-spot blob from one trace; writes "
                        "OUTPUT_000.png .. and OUTPUT_movie.npz (times, "
                        "light curve, raw frames); no GIF is written")
    p.add_argument("--orbits", type=float, default=1.0,
                   help="blob orbits covered by the movie")
    p.add_argument("--spot-amp", type=float, default=5.0,
                   help="blob peak emissivity (movie mode)")
    p.add_argument("--spot-r", type=float, default=6.0,
                   help="blob orbit radius [M]")
    p.add_argument("--centroid", default=None, metavar="PLOT.png",
                   help="with --movie: the photocenter track and light "
                        "curve written as PLOT.csv (phase, x_arcsec, "
                        "y_arcsec, flux_over_mean; no plot is drawn)")
    p.add_argument("--decompose", default=None, metavar="PANEL.png",
                   help="photon-ring order decomposition from one trace: "
                        "writes PANEL_composite.png, PANEL_n0.png .. on a "
                        "shared tone map and PANEL.npz (layers, fluxes, "
                        "radii, winding); no matplotlib panel is drawn")
    p.add_argument("--orders", type=int, default=3,
                   help="image orders for --decompose (>= 2)")
    p.add_argument("--spot-sigma", type=float, default=1.0,
                   help="blob Gaussian size [M]")
    p.add_argument("--fps", type=float, default=12.0,
                   help="movie frame rate (kept for the JAX package's "
                        "command line; no animated file is written)")
    p.add_argument("--polarization", default=None, metavar="PLOT.png",
                   help="polarized mode (Kerr only, optically thin): "
                        "Stokes I/Q/U path integrals; writes the intensity "
                        "map to PLOT.png, the polarization fraction to "
                        "PLOT_pol_frac.png and evpa, pol_frac, I, Q, U to "
                        "PLOT.npz; no EVPA tick overlay is drawn")
    p.add_argument("--b-field", default="toroidal",
                   choices=["vertical", "toroidal", "radial"],
                   help="magnetic-field geometry for --polarization")
    p.add_argument("--output", default="volumetric.png")
    p.add_argument("--visibility", metavar="PATH",
                   help="baseline-domain |V| radial profile of the raw "
                        "intensity, saved as .npz; the first-null ring "
                        "diameter is printed")
    p.set_defaults(fn=cmd_volumetric)
