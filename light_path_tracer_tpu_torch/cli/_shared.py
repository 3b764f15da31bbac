"""Shared CLI plumbing: flag groups and scene/config construction, with
the JAX package's flag names and defaults."""

from __future__ import annotations

import sys

import numpy as np


def _add_scene_args(p):
    p.add_argument("--M", type=float, default=1.0, help="BH mass")
    p.add_argument("--a", type=float, default=0.0,
                   help="BH spin (|a| <= M, 0 = Schwarzschild)")
    p.add_argument("--Q", type=float, default=0.0,
                   help="BH charge (Reissner-Nordstrom; with --a != 0: "
                        "Kerr-Newman, needs a^2 + Q^2 <= M^2; the disk "
                        "and volumetric modes take it at any spin, all but "
                        "--polarization, which is Kerr-only)")
    p.add_argument("--eps3", type=float, default=0.0,
                   help="Johannsen-Psaltis deformation parameter "
                        "(test-GR deformed Kerr; 0 = GR. Shadow and lens "
                        "modes; mutually exclusive with --Q, not wired "
                        "for disk orbital dynamics)")
    p.add_argument("--metric-py", default=None, metavar="FILE.py:ATTR",
                   help="user-defined spacetime: load a covariant-"
                        "components function (r, th) -> (g_tt, g_tphi, "
                        "g_rr, g_thth, g_phiphi) written with torch (or "
                        "a ready CustomMetric) from a local Python file "
                        "(models.custom.CustomMetric; --M/--a declare "
                        "the asymptotic Kerr the far field approaches). "
                        "Shadow/lens/magnification/AA/ray/plot modes; "
                        "traced on the plain PyTorch loop on any device; "
                        "mutually exclusive with --Q/--eps3")
    p.add_argument("--r-obs", type=float, default=100.0,
                   help="Observer distance in units of M (default: 100)")
    p.add_argument("--psi-y", type=float, default=0.0,
                   help="BH vertical offset in deg (+ = top, - = bottom)")
    p.add_argument("--psi-x", type=float, default=0.0,
                   help="BH horizontal offset in deg (+ = right, - = left)")
    p.add_argument("--fov-v", type=float, default=40.0,
                   help="Vertical field of view in deg")
    p.add_argument("--theta-obs", type=float, default=90.0,
                   help="Observer inclination from the spin axis in deg "
                        "(default: 90 = equatorial)")
    p.add_argument("--boost", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   metavar=("BX", "BY", "BZ"),
                   help="camera 3-velocity in units of c (camera coords: "
                        "+x right, +y down, +z toward the BH); aberrates "
                        "the view and Doppler-shifts the disk")


def _add_render_args(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device: 'cuda' runs the hand-written CUDA "
                        "kernels, 'cpu' their plain PyTorch loops")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"],
                   help="ray dtype: the CUDA kernels have float32 and "
                        "float64 instances")
    p.add_argument("--chunk-size", type=int, default=0,
                   help="rays per chunk (0 = whole grid in one dispatch)")
    p.add_argument("--progress", default="off",
                   choices=["off", "bar", "live"],
                   help="chunked-trace progress: tqdm bar or the live "
                        "ANSI bar with CPU/RSS telemetry (needs "
                        "--chunk-size)")
    p.add_argument("--no-symmetry", action="store_true",
                   help="disable top/bottom mirror symmetry")
    p.add_argument("--loop-around", action="store_true",
                   help="wrap out-of-FOV source samples (legacy mode)")
    p.add_argument("--cache", action="store_true",
                   help="cache traced lookup tables in lookup_cache/ "
                        "(lens)")
    p.add_argument("--precision", default="fast",
                   choices=["fast", "precise", "gate"],
                   help="tolerance tier: fast (throughput), precise, or "
                        "gate (accuracy tier)")
    p.add_argument("--integrator", default="dp45",
                   choices=["dp45", "dop853", "rk4"],
                   help="Kerr integrator: dp45 (Dormand-Prince 4(5)), "
                        "dop853 (Hairer's 8(5,3)) or rk4 (the fixed-step "
                        "comparison tracer, plain PyTorch on any device)")
    p.add_argument("--max-steps", type=int, default=200000,
                   help="adaptive-step budget per ray")
    p.add_argument("--sampling", default="nearest",
                   choices=["nearest", "bilinear"],
                   help="background-texture sampling of the lensed render")
    p.add_argument("--bilinear", action="store_const", dest="sampling",
                   const="bilinear", help="same as --sampling bilinear")


def _add_multihost_args(p):
    p.add_argument("--multihost", action="store_true",
                   help="multi-process render (not ported yet)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (--multihost)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count (--multihost)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id, 0..N-1 (--multihost)")
    p.add_argument("--init-timeout", type=float, default=60.0,
                   help="seconds to wait for the cluster (--multihost)")
    p.add_argument("--heartbeat-timeout", type=float, default=None,
                   help="seconds before a dead peer is detected "
                        "(--multihost)")


def _stem(path, suffix):
    """`path` with its extension replaced by `suffix`; an animated or
    vector format is refused (this package writes PNG only)."""
    base, _, ext = path.rpartition(".")
    if not base or ext.lower() != "png":
        raise ValueError(
            f"{path!r}: the PyTorch package writes PNG files (one per "
            f"frame or order) and .npz arrays; give a .png path")
    return base + suffix


def not_ported(what: str):
    """The error a flag or mode that is not ported yet raises."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md, "
        f"Queue 1)")


def _visibility_report(image, fov, path, model, true_diameter=None):
    """The visibility-domain analysis of an image (observables.py): save
    the |V| radial profile (baselines, amp, b_null, diameter_rad, model)
    as .npz at `path` and print the first-null diameter."""
    from light_path_tracer_tpu_torch import observables as obs
    # The padded FFT grid is pad*H x pad*W: kept near 8k^2.
    side = max(tuple(image.shape)[:2])
    pad = max(2, min(8, 8192 // side))
    est, b_null, (baselines, amp) = obs.shadow_diameter(
        image, fov, model=model, pad=pad, n_bins=512)
    np.savez(path, baselines=baselines.cpu().numpy(),
             amp=amp.cpu().numpy(), b_null=b_null, diameter_rad=est,
             model=model)
    if np.isfinite(b_null):
        line = (f"  visibility: first null at {b_null:,.1f} wavelengths"
                f" -> {model}-model diameter {np.degrees(est):.4f} deg")
        if true_diameter is not None:
            line += f" (2*alpha_crit = {np.degrees(true_diameter):.4f})"
        print(line)
    else:
        print("  visibility: no null within the sampled baselines "
              "(featureless image or field of view too tight)")
    print(f"Saved: {path}")


def _centroid_report(path, scene, size, emission, light_curve, spot_r):
    """The photocentre track of the raw per-frame emission
    (observables.centroid_track) beside the light curve, written as the
    CSV columns of the JAX package's figure (orbital phase, x and y in
    arcsec with y up, flux over its mean) to PATH.csv; prints the
    wobble. No figure is drawn."""
    import torch
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.observables import centroid_track
    fov = camera.fov_from_vertical(scene.vertical_fov, (size, size))
    track = np.degrees(centroid_track(
        torch.as_tensor(emission).to(torch.float64), fov).cpu().numpy())
    lc = np.asarray(torch.as_tensor(light_curve).cpu(), np.float64)
    ph = np.arange(len(track)) / max(len(track), 1)
    csv = _stem(path, ".csv")
    np.savetxt(csv, np.column_stack([ph, track[:, 0] * 3600,
                                     -track[:, 1] * 3600,
                                     lc / max(lc.mean(), 1e-300)]),
               delimiter=",", header="phase,x_arcsec,y_arcsec,flux_over_mean")
    ext = np.ptp(track, axis=0) * 3600
    print(f"  centroid wobble: {ext[0]:.3f} x {ext[1]:.3f} "
          f"arcsec (spot orbit diameter "
          f"{np.degrees(2 * spot_r / scene.r_obs) * 3600:.3f} arcsec)")
    print(f"Saved: {csv}")


def _scene_from(args):
    from light_path_tracer_tpu_torch.utils.config import SceneConfig
    custom = None
    spec = getattr(args, "metric_py", None)
    if spec:
        if args.Q or args.eps3:
            raise SystemExit(
                "error: --metric-py is mutually exclusive with "
                "--Q/--eps3 (the user metric defines the spacetime)")
        from light_path_tracer_tpu_torch.models import load_user_metric
        custom = load_user_metric(spec, M=args.M, a=args.a)
        if (custom.M != args.M or custom.a != args.a) and (
                args.M != 1.0 or args.a != 0.0):
            print(f"note: {spec} is a CustomMetric instance with "
                  f"M={custom.M}, a={custom.a}; ignoring --M/--a")
    return SceneConfig(
        M=args.M, a=args.a, Q=args.Q, eps3=args.eps3,
        r_obs_mult=args.r_obs,
        psi_y=float(np.radians(args.psi_y)),
        psi_x=float(np.radians(args.psi_x)),
        vertical_fov_deg=args.fov_v,
        theta_obs=float(np.radians(args.theta_obs)),
        boost=tuple(args.boost), custom_metric=custom)


def _reject_metric_py(args, mode: str) -> bool:
    """Modes whose physics needs the closed-form families (disk orbits,
    volumetric flows, stellar surfaces, run-time sweeps) refuse
    --metric-py: prints the error and returns True."""
    if getattr(args, "metric_py", None):
        print(f"error: --metric-py is not supported in {mode} mode "
              "(supported: shadow, lens, magnification, AA, ray, "
              "plot)", file=sys.stderr)
        return True
    return False


def _render_cfg_from(args):
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    return RenderConfig(
        dtype=args.dtype,
        max_steps=args.max_steps,
        chunk_size=args.chunk_size or None,
        use_tb_symmetry=not args.no_symmetry,
        render_loop_around=args.loop_around,
        precision=args.precision,
        integrator=args.integrator,
        sampling=args.sampling,
        progress={"off": False, "bar": True, "live": "live"}[args.progress])
