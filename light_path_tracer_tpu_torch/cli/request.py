"""`request` subcommand: offline replay of serve-style JSON requests."""

from __future__ import annotations


def cmd_request(args) -> int:
    """Offline replay of a serve-style JSON request (serve.py's POST
    /render body): the same decode, dispatch and display encodings as the
    HTTP layer, without the server, on `--device` (the card by default).
    Reproducible scene files and local debugging of recorded requests."""
    import json as _json
    from light_path_tracer_tpu_torch.serve import RenderService, render_request
    from light_path_tracer_tpu_torch.utils.save import read_png
    with open(args.request) as f:
        req = _json.load(f)
    src = read_png(args.image) if args.image else None
    fmt = "npy" if args.output.endswith(".npy") else "png"
    try:
        body, _ctype, dt, _cache = render_request(
            req, svc=RenderService(device=args.device), source_image=src,
            fmt=fmt)
    except (ValueError, TypeError, KeyError) as exc:
        raise SystemExit(
            f"error: bad request: {type(exc).__name__}: {exc}")
    with open(args.output, "wb") as f:
        f.write(body)
    print(f"Rendered mode={req.get('mode', 'shadow')} "
          f"in {dt:.3f}s")
    print(f"Saved: {args.output}")
    return 0


def register(sub):
    p = sub.add_parser(
        "request", help="offline replay of a serve-style JSON request "
                        "(the POST /render body, rendered locally "
                        "through the exact serving contract)")
    p.add_argument("request", help="path to the request JSON file")
    p.add_argument("--image", default=None,
                   help="8-bit PNG background for lens/composite "
                        "(replaces the request's image_b64)")
    p.add_argument("--output", default="request_out.png",
                   help=".png (display-encoded) or .npy (raw arrays)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device: 'cuda' runs the hand-written CUDA "
                        "kernels, 'cpu' their plain PyTorch loops")
    p.set_defaults(fn=cmd_request)
