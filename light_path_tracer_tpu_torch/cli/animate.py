"""`animate` subcommand: camera-pan and flyby sequences.

The JAX package's `animate` (sequence.render_sequence for a pan,
sequence.render_flyby for `--flyby R0:R1` with `--boost-to`): the frames
go through the hybrid tracer on `--device`. Every frame is written as a
PNG beside the output name (OUTPUT_000.png, ...) and all of them as one
OUTPUT_frames.npz (frames, and each frame's launches and ms); the
animated GIF at --output is written too where Pillow imports. Prints the
JAX package's summary line (frames, size, first frame, ms/frame) and the
Kerr launches of each frame. `--image` takes an 8-bit PNG source
(utils/save.read_png); `--max-steps` bounds the adaptive attempts a ray.
"""

from __future__ import annotations

import time

import numpy as np

from light_path_tracer_tpu_torch.cli._shared import (_add_scene_args,
                                                     _reject_metric_py,
                                                     _scene_from)


def _frame_paths(output, n):
    """(stem, frame paths): the stem is OUTPUT without its .gif or .png
    extension, the frames STEM_000.png, ..."""
    base, dot, ext = output.rpartition(".")
    stem = base if dot and ext.lower() in ("gif", "png") else output
    return stem, [f"{stem}_{k:03d}.png" for k in range(n)]


def _u8(a):
    """A frame as 8-bit RGB: clip to [0, 1], gray repeated, then the
    float -> uint8 truncation."""
    a = np.clip(np.asarray(a, np.float32), 0.0, 1.0)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, axis=-1)
    return (a[..., :3] * 255).astype(np.uint8)


def _write_gif(path, frames, fps) -> bool:
    try:
        from PIL import Image
    except ImportError:
        return False
    pils = [Image.fromarray(f) for f in frames]
    pils[0].save(path, save_all=True, append_images=pils[1:],
                 duration=int(1000 / fps), loop=0)
    return True


def cmd_animate(args) -> int:
    """Camera-pan or flyby sequence -> PNG frames, .npz and (with Pillow)
    the GIF."""
    if _reject_metric_py(args, "animate"):
        return 2
    from light_path_tracer_tpu_torch.sequence import (render_flyby,
                                                      render_sequence)
    from light_path_tracer_tpu_torch.utils.save import read_png, write_png

    scene = _scene_from(args)
    n_frames = max(args.frames, 1)
    src = read_png(args.image) if args.image else None
    kw = dict(source_image=src, resolution=(args.size, args.size),
              max_steps=args.max_steps, device=args.device)

    if args.flyby:
        if scene.Q:
            print("error: --flyby traces the metric through the "
                  "uncharged TracedKerr fast path; --Q is not "
                  "supported with --flyby (pan animations are)")
            return 2
        try:
            r0, r1 = (float(x) for x in args.flyby.split(":"))
        except ValueError:
            print(f"error: --flyby expects R0:R1 (units of M), got "
                  f"{args.flyby!r}")
            return 2
        ts = [i / max(n_frames - 1, 1) for i in range(n_frames)]
        frames = [(scene.psi_y, scene.psi_x, (r0 + (r1 - r0) * t) * scene.M,
                   (0.0, 0.0, args.boost_to * t)) for t in ts]

        def render(fr, stats):
            return render_flyby(scene, fr, frame_stats=stats, **kw)
    else:
        pan = np.radians(args.pan_deg)
        frames = [(scene.psi_y, scene.psi_x - pan / 2 + pan * i /
                   max(n_frames - 1, 1)) for i in range(n_frames)]

        def render(fr, stats):
            return render_sequence(scene, fr, frame_stats=stats, **kw)

    stats = []
    t0 = time.perf_counter()
    first = render(frames[:1], stats)[0].cpu().numpy()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest = render(frames[1:], stats)
    imgs = [first] + [f.cpu().numpy() for f in rest]
    dt = (time.perf_counter() - t0) / max(n_frames - 1, 1)

    stem, paths = _frame_paths(args.output, n_frames)
    u8 = [_u8(a) for a in imgs]
    for path, frame in zip(paths, u8):
        write_png(path, frame)
    npz = f"{stem}_frames.npz"
    np.savez(npz, frames=np.stack(imgs),
             launches=np.array([s["launches"] for s in stats]),
             ms=np.array([s["ms"] for s in stats]))
    gif = args.output.lower().endswith(".gif") and _write_gif(
        args.output, u8, args.fps)
    print(f"Animation: {n_frames} frames at {args.size}x{args.size}, "
          f"first frame {t_first:.1f}s, then {dt * 1000:.0f} ms/frame "
          f"({1 / max(dt, 1e-9):.1f} fps)")
    print(f"  launches per frame: {[s['launches'] for s in stats]}; ms per "
          f"frame: {[round(s['ms'], 3) for s in stats]}")
    print(f"Saved: {paths[0]} .. {paths[-1]} + {npz}"
          + (f" + {args.output}" if gif else
             " (no GIF: Pillow is not installed)"
             if args.output.lower().endswith(".gif") else ""))
    return 0


def register(sub):
    p = sub.add_parser("animate", help="camera-pan or flyby sequence (PNG "
                                       "frames, .npz, GIF with Pillow)")
    _add_scene_args(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device: 'cuda' runs the hand-written CUDA "
                        "kernels, 'cpu' their plain PyTorch loops")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--pan-deg", type=float, default=2.0,
                   help="total horizontal pan across the sequence")
    p.add_argument("--flyby", default=None, metavar="R0:R1",
                   help="approach animation instead of a pan: observer "
                        "radius ramps R0 -> R1 (units of M), radius and "
                        "boost run-time parameters of the trace")
    p.add_argument("--boost-to", type=float, default=0.0,
                   help="with --flyby: forward boost ramps 0 -> this "
                        "(units of c; shadow shrinks by aberration)")
    p.add_argument("--image", default=None,
                   help="background 8-bit PNG (default: shadow-only "
                        "frames)")
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--max-steps", type=int, default=20000,
                   help="adaptive-step budget per ray")
    p.add_argument("--output", default="pan.gif",
                   help="the GIF (with Pillow); frames go to "
                        "OUTPUT_000.png.. and OUTPUT_frames.npz")
    p.set_defaults(fn=cmd_animate)
