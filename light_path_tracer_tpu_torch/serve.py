"""Render serving: a warm HTTP endpoint on one CUDA device.

The counterpart of `light_path_tracer_tpu.serve`: a standard-library HTTP
server that keeps one process, its card and its kernel libraries warm
across requests. A request's signature is its whole (mode, size, scene,
render, disk, riaf, star) configuration; the first request of a signature
is "cold", every later one "warm" (the `X-Cache` header). The kernels
are built once per machine, not once per signature: the first request on
a fresh machine that needs a kernel library (DP45 and the orbit kernel,
"more", "broad", "surface", DOP853) waits for its nvcc build, tens of
seconds to a few minutes, into `build/light_path_tracer_tpu_torch/` beside
the package, where a later process finds it (the counterpart of the JAX
package's compilation cache). `deadline_s` bounds only the wait for the
render lock, so a request queued behind such a build gets 503 after its
deadline (120 s by default).

Protocol (JSON over HTTP, no external deps), the JAX package's:

    POST /render
        {"mode": "shadow" | "lens" | "disk" | "composite"
                 | "magnification" | "caustics" | "timedelay" | "shear"
                 | "volumetric" | "star",
         "scene":  {... SceneConfig fields, angles in DEGREES ...},
         "render": {... RenderConfig fields ...},
         "disk":   {... DiskConfig fields (disk/composite modes) ...},
         "riaf":   {... RIAFConfig fields (volumetric mode) ...},
         "star":   {... StarConfig fields (star mode) ...},
         "size": [H, W]                 (lens/composite use the image),
         "image_b64": "<base64 PNG/NPY>" (lens/composite background),
         "deadline_s": seconds to wait for the render lock,
         "format": "png" | "npy"}
    -> 200, body = the image (PNG bytes or a .npy array), headers
       X-Render-Seconds / X-Cache (warm|cold).

    GET /healthz  -> {"ok": true, "devices": N, "platform": "gpu"|"cpu"}
    GET /stats    -> per-signature request counts + timing summary

Run:  python -m light_path_tracer_tpu_torch.serve --port 8080
      python -m light_path_tracer_tpu_torch.serve --device cpu --port 0

The PNG of a 2-D image is matplotlib's imsave(cmap="gray", vmin=0,
vmax=1) pixels, an RGB(A) image's its clip-then-truncate to 8 bits, both
as RGBA; the map modes' PNGs take utils/color.py's colour tables
(their numbers are the JAX package's, their colours its anchors). No
matplotlib is needed.

Threads: ThreadingHTTPServer runs each request on a thread of its own,
and requests serialise through one render lock. Every CUDA allocation and
launch of a request, the background image's upload included, happens
inside the lock (decode_request returns NumPy): the RK4 path captures CUDA
graphs (ops/graphs.py) in torch.cuda.graph's global capture mode, which
an allocation from another thread would break. /healthz and /stats never
take the lock; /healthz calls only torch.cuda.device_count(). More
throughput comes from more processes, one a card.

Overload: at most `max_queue` requests may wait for the render lock;
beyond that /render replies 503 {"error": "overloaded"} at once, with
Retry-After. A request whose deadline passes before it gets the lock
gets 503 {"error": "deadline exceeded"}. A render that has started runs
to its end. Client errors are 400, unknown paths 404, render failures
500.
"""

from __future__ import annotations

import base64
import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

_DEG_FIELDS = {"psi_y", "psi_x", "theta_obs"}          # degrees in JSON
_DISK_DEG_FIELDS = {"tilt", "tilt_azimuth"}


def _scene_from_json(d: dict) -> SceneConfig:
    kw = {}
    for key, val in (d or {}).items():
        if key == "custom_metric":
            # A user metric loads local Python (models.load_user_metric):
            # a trust boundary not reachable over HTTP.
            raise ValueError(
                "custom_metric is not accepted over HTTP; use the "
                "CLI --metric-py locally")
        if key == "boost":
            kw[key] = tuple(float(v) for v in val)
        elif key in _DEG_FIELDS:
            kw[key] = math.radians(float(val))
        else:
            kw[key] = val
    return SceneConfig(**kw)


def _render_cfg_from_json(d: dict) -> RenderConfig:
    return RenderConfig(**(d or {}))


def _disk_cfg_from_json(d: dict):
    from light_path_tracer_tpu_torch.disk import DiskConfig
    kw = dict(d or {})
    for key in _DISK_DEG_FIELDS:
        if key in kw:
            kw[key] = math.radians(float(kw[key]))
    if not kw.get("warp_radius"):
        # 0 means a flat plane at the API boundary, as on the CLI.
        kw.pop("warp_radius", None)
    return DiskConfig(**kw)


def _riaf_cfg_from_json(d: dict):
    from light_path_tracer_tpu_torch.volumetric import RIAFConfig
    riaf = RIAFConfig(**dict(d or {}))
    # render_volumetric checks these too; here a bad value is a 400, not
    # a 500 mid-render.
    if riaf.profile not in ("torus", "powerlaw", "shell", "jet"):
        raise ValueError(f"riaf.profile must be 'torus', 'powerlaw', "
                         f"'shell' or 'jet', got {riaf.profile!r}")
    if not 0.0 <= riaf.jet_beta < 1.0:
        raise ValueError(f"riaf.jet_beta must be in [0, 1), got "
                         f"{riaf.jet_beta}")
    if riaf.profile == "shell" and not riaf.shell_out > riaf.shell_in:
        raise ValueError("shell profile needs shell_out > shell_in")
    return riaf


def _star_cfg_from_json(d: dict):
    from light_path_tracer_tpu_torch.star import StarConfig
    kw = dict(d or {})
    if "spots" in kw:
        kw["spots"] = tuple(tuple(float(v) for v in s)
                            for s in kw["spots"])
    star = StarConfig(**kw)
    # The metric-free part of render_star's validation, so a malformed
    # spot list is a 400, not a 500.
    for spot in star.spots:
        if len(spot) != 4:
            raise ValueError("each star.spots entry is (colat_deg, "
                             f"az_deg, radius_deg, T), got {spot!r}")
    return star


def _decode_image(b64: str) -> np.ndarray:
    """A base64 .npy array or 8-bit PNG (utils/save.read_png: float32 in
    [0, 1], as matplotlib's imread returns it) as a NumPy array."""
    from light_path_tracer_tpu_torch.utils.save import read_png
    raw = base64.b64decode(b64)
    if raw[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(raw), allow_pickle=False)
    return read_png(raw)


# matplotlib's gray colour table as 8-bit levels: entry i is
# (255 x_i) / 255 with x_i = linspace(0, 1, 256)[i], as its linear segment
# rounds it, times 255 and truncated.
_GRAY = np.concatenate([[0.0], (255.0 * np.linspace(0.0, 1.0, 256)[1:-1])
                        / 255.0, [1.0]]) * 255.0
_GRAY = _GRAY.astype(np.uint8)


def _png_pixels(img: np.ndarray) -> np.ndarray:
    """The RGBA uint8 pixels matplotlib's imsave writes for clip(img, 0,
    1): a 2-D image through the gray table with vmin 0, vmax 1 (index
    int(x * 256), 256 -> 255; NaN transparent black), an RGB(A) image
    truncated to 8 bits (an RGB image opaque; a pixel with a NaN channel
    all 0)."""
    x = np.clip(img, 0.0, 1.0)
    if x.ndim == 2:
        bad = np.isnan(x)
        idx = np.minimum(np.where(bad, 0.0, x) * 256, 255).astype(np.int64)
        out = np.empty(x.shape + (4,), np.uint8)
        out[..., :3] = _GRAY[idx][..., None]
        out[..., 3] = 255
        out[bad] = 0
        return out
    if x.ndim != 3 or x.shape[2] not in (3, 4):
        raise ValueError(f"cannot encode an image of shape {x.shape}")
    rgba = np.empty(x.shape[:2] + (4,), x.dtype)
    rgba[..., :x.shape[2]] = x
    if x.shape[2] == 3:
        rgba[..., 3] = 1
    rgba[np.isnan(x).any(axis=2)] = 0
    return (rgba * 255).astype(np.uint8)


def _encode_image(img: np.ndarray, fmt: str) -> tuple[bytes, str]:
    img = np.asarray(img)
    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, img, allow_pickle=False)
        return buf.getvalue(), "application/octet-stream"
    from light_path_tracer_tpu_torch.utils.save import encode_png
    return encode_png(_png_pixels(img)), "image/png"


def _display_encode(mode: str, img: np.ndarray, fmt: str) -> np.ndarray:
    """PNG display encodings of the raw-map modes (npy ships the raw
    arrays untouched): the signed-mu display for magnification
    (render.magnification_display), the omega panel on the diverging
    RdBu_r table for shear, log-compressed inferno / viridis for caustics
    / timedelay; non-finite pixels black. The scalar that enters each
    colour table is the JAX package's; the tables are utils/color.py's.
    Shared by the HTTP handler and the offline `render_request`."""
    if fmt != "png":
        return img
    from light_path_tracer_tpu_torch.utils.color import colormap
    if mode == "magnification":
        from light_path_tracer_tpu_torch.render import magnification_display
        return magnification_display(img)
    if mode == "shear":
        om = np.asarray(img[3], np.float64)
        fin = np.isfinite(om)
        lim = (float(np.percentile(np.abs(om[fin]), 99.0))
               if fin.any() else 1.0) or 1.0
        rgb = colormap("RdBu_r", np.clip(0.5 + 0.5 * om / lim, 0.0, 1.0))
        rgb[~fin] = 0.0
        return rgb
    if mode in ("caustics", "timedelay"):
        raw = np.asarray(img, np.float64)
        disp = np.log10(1.0 + np.nan_to_num(
            np.maximum(raw, 0.0), nan=0.0))
        lim = float(np.nanpercentile(disp, 99.5)) or 1.0
        rgb = colormap("inferno" if mode == "caustics" else "viridis",
                       np.clip(disp / lim, 0.0, 1.0))
        rgb[~np.isfinite(raw)] = 0.0
        return rgb
    return img


_MODES = ("shadow", "lens", "disk", "composite", "magnification",
          "caustics", "timedelay", "shear", "volumetric", "star")


def decode_request(req: dict, source_image=None):
    """Decode one /render request dict into RenderService.render()
    arguments. Shared by the HTTP handler and the offline replay
    (`render_request`, CLI `request`), so a recorded request replays
    against the serving contract. Raises ValueError / TypeError /
    KeyError on anything malformed (the HTTP layer maps those to 400).
    Everything it returns lives on the host (the background image as
    NumPy): the render uploads it inside the render lock.

    source_image, when given, replaces the request's `image_b64` for
    lens/composite (the CLI loads it from a local path); the HTTP path
    never passes it, so a missing image_b64 stays a client error.
    """
    mode = req.get("mode", "shadow")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    scene = _scene_from_json(req.get("scene", {}))
    cfg = _render_cfg_from_json(req.get("render", {}))
    disk = (_disk_cfg_from_json(req.get("disk", {}))
            if mode in ("disk", "composite") else None)
    riaf = (_riaf_cfg_from_json(req.get("riaf", {}))
            if mode == "volumetric" else None)
    star = (_star_cfg_from_json(req.get("star", {}))
            if mode == "star" else None)
    if mode in ("lens", "composite"):
        src = (source_image if source_image is not None
               else _decode_image(req["image_b64"]))
    else:
        src = None
    size = req.get("size", [256, 256])
    if mode in ("shadow", "disk", "magnification", "caustics",
                "timedelay", "shear", "volumetric", "star"):
        if len(size) != 2 or any(int(v) <= 0 for v in size):
            raise ValueError(
                f"size must be two positive ints, got {size!r}")
        size = [int(v) for v in size]
    deadline_s = req.get("deadline_s")
    if deadline_s is not None:
        deadline_s = float(deadline_s)
        if deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
    return (mode, scene, cfg, disk, riaf, star, src, size, deadline_s)


def render_request(req: dict, svc=None, source_image=None,
                   fmt: str | None = None):
    """Render one /render-shaped request dict without the HTTP layer.

    The offline twin of POST /render: the same decode, mode dispatch
    (RenderService) and display encodings, so the body is the HTTP
    response's bytes for the same request. Replays recorded requests
    locally (`python -m light_path_tracer_tpu_torch request req.json`).

    Returns (body_bytes, content_type, seconds, "warm"|"cold"). `fmt`
    overrides the request's "format"; `source_image` replaces image_b64
    for lens/composite; `svc` defaults to a new RenderService on the
    card.
    """
    (mode, scene, cfg, disk, riaf, star, src, size,
     deadline_s) = decode_request(req, source_image=source_image)
    if fmt is None:
        fmt = req.get("format", "png")
    service = svc if svc is not None else RenderService()
    img, dt, cache = service.render(
        mode, scene, cfg, size=size, source_image=src, disk=disk,
        riaf=riaf, star=star, deadline_s=deadline_s)
    img = _display_encode(mode, img, fmt)
    body, ctype = _encode_image(img, fmt)
    return body, ctype, dt, cache


class Overloaded(RuntimeError):
    """Too many requests already waiting for the render lock."""


class DeadlineExceeded(RuntimeError):
    """The render lock was not acquired within the request deadline."""


def _host(x) -> np.ndarray:
    """A render's output as a NumPy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RenderService:
    """Mode dispatch and warm-signature accounting (transport-agnostic).

    device: where requests render ("cuda", the default, or "cpu").
    max_queue: how many requests may wait for the render lock at once
    (the running one is not counted); further requests get Overloaded.
    default_deadline_s: the queue-wait bound of a request that does not
    set "deadline_s" itself.
    """

    def __init__(self, max_queue: int = 4,
                 default_deadline_s: float = 120.0, device="cuda"):
        self._lock = threading.Lock()
        self._meta = threading.Lock()   # guards _waiting + _signatures
        self._waiting = 0
        self.max_queue = int(max_queue)
        self.default_deadline_s = float(default_deadline_s)
        self.device = str(device)
        self.platform = ("gpu" if torch.device(self.device).type == "cuda"
                         else "cpu")
        self._signatures: dict[str, dict] = {}

    def signature(self, mode, scene: SceneConfig, cfg: RenderConfig,
                  size, disk, riaf=None, star=None) -> str:
        """A request's identity for the warm / cold accounting: every
        input except the background image."""
        return json.dumps([mode, list(size or ()), repr(scene),
                           repr(cfg), repr(disk), repr(riaf),
                           repr(star)], sort_keys=True)

    def _dispatch(self, mode, scene, cfg, size, source_image, disk, riaf,
                  star):
        """The mode's render on self.device; returns the image (the shear
        maps stacked) as NumPy."""
        dev = self.device
        if mode == "shadow":
            from light_path_tracer_tpu_torch.pipeline import render_shadow
            img, _stats = render_shadow(scene, tuple(size), cfg, device=dev)
        elif mode == "lens":
            from light_path_tracer_tpu_torch.pipeline import render_scene
            img = render_scene(scene, source_image, cfg, device=dev).image
        elif mode == "disk":
            from light_path_tracer_tpu_torch.disk import render_disk
            img, _stats = render_disk(scene, tuple(size), cfg, disk,
                                      device=dev)
        elif mode == "magnification":
            from light_path_tracer_tpu_torch.pipeline import (
                render_magnification)
            img, _stats = render_magnification(scene, tuple(size), cfg,
                                               device=dev)
        elif mode == "caustics":
            # size is the traced grid; the map bins at size / 2 (>= ~4
            # rays a bin).
            from light_path_tracer_tpu_torch.pipeline import render_caustics
            img, _extent, _stats = render_caustics(
                scene, tuple(size), cfg, bins=max(int(size[0]) // 2, 8),
                device=dev)
        elif mode == "timedelay":
            from light_path_tracer_tpu_torch.pipeline import (
                render_time_delay)
            img, _stats = render_time_delay(scene, tuple(size), cfg,
                                            device=dev)
        elif mode == "shear":
            # The five maps stacked (kappa, gamma1, gamma2, omega, gamma).
            from light_path_tracer_tpu_torch.pipeline import render_shear
            maps, _stats = render_shear(scene, tuple(size), cfg, device=dev)
            return np.stack([_host(maps[k]) for k in
                             ("kappa", "gamma1", "gamma2", "omega",
                              "gamma")])
        elif mode == "volumetric":
            from light_path_tracer_tpu_torch.volumetric import (
                RIAFConfig, render_volumetric)
            img, _stats = render_volumetric(
                scene, tuple(size), cfg, riaf or RIAFConfig(), device=dev)
        elif mode == "star":
            from light_path_tracer_tpu_torch.star import (StarConfig,
                                                          render_star)
            img, _stats = render_star(scene, tuple(size), cfg,
                                      star or StarConfig(), device=dev)
        elif mode == "composite":
            from light_path_tracer_tpu_torch.disk import (
                composite_gamma_encode, render_scene_with_disk)
            img, stats = render_scene_with_disk(scene, source_image, cfg,
                                                disk, device=dev)
            if disk.spectrum == "blackbody":
                img = composite_gamma_encode(img, stats["disk_mask"])
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return _host(img)

    def render(self, mode: str, scene: SceneConfig, cfg: RenderConfig,
               size=None, source_image=None, disk=None, riaf=None,
               star=None, deadline_s: float | None = None):
        """Returns (image ndarray, seconds, cache 'warm'|'cold').

        Raises Overloaded when max_queue requests already wait, and
        DeadlineExceeded when the render lock is not acquired within
        deadline_s (default: self.default_deadline_s). A render that
        has started always runs to completion; the seconds include the
        copy of the image to the host.
        """
        deadline = (self.default_deadline_s if deadline_s is None
                    else float(deadline_s))
        sig = self.signature(mode, scene, cfg, size, disk, riaf, star)
        with self._meta:
            if self._waiting >= self.max_queue:
                raise Overloaded(
                    f"{self._waiting} requests already queued "
                    f"(max_queue={self.max_queue})")
            self._waiting += 1
        try:
            if not self._lock.acquire(timeout=max(deadline, 0.0)):
                raise DeadlineExceeded(
                    f"render lock not acquired within {deadline:.1f}s")
        finally:
            with self._meta:
                self._waiting -= 1
        try:
            with self._meta:
                entry = self._signatures.setdefault(
                    sig, {"count": 0, "total_s": 0.0, "mode": mode})
                warm = entry["count"] > 0
            t0 = time.perf_counter()
            img = self._dispatch(mode, scene, cfg, size, source_image,
                                 disk, riaf, star)
            dt = time.perf_counter() - t0
            with self._meta:
                entry["count"] += 1
                entry["total_s"] += dt
        finally:
            self._lock.release()
        return img, dt, ("warm" if warm else "cold")

    def stats(self) -> dict:
        with self._meta:
            return {
                "signatures": len(self._signatures),
                "requests": sum(e["count"]
                                for e in self._signatures.values()),
                "waiting": self._waiting,
                "max_queue": self.max_queue,
                "per_signature": [
                    {"mode": e["mode"], "count": e["count"],
                     "mean_s": e["total_s"] / max(e["count"], 1)}
                    for e in self._signatures.values()],
            }

    def health(self) -> dict:
        """/healthz's reply; touches no render state and no lock."""
        devices = (torch.cuda.device_count() if self.platform == "gpu"
                   else 1)
        return {"ok": True, "devices": devices, "platform": self.platform}


def make_server(host: str = "127.0.0.1", port: int = 0,
                service: RenderService | None = None):
    """Build (but don't start) the HTTP server; port=0 picks a free one."""
    svc = service or RenderService()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):           # quiet by default
            pass

        def _reply(self, code, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for key, val in extra:
                self.send_header(key, val)
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code, obj, extra=()):
            self._reply(code, json.dumps(obj).encode(),
                        "application/json", extra)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply_json(200, svc.health())
            elif self.path == "/stats":
                self._reply_json(200, svc.stats())
            else:
                self._reply_json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/render":
                self._reply_json(404, {"error": "unknown path"})
                return
            replied = False
            try:
                # Anything wrong in the request is the client's: 400.
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    (mode, scene, cfg, disk, riaf, star, src, size,
                     deadline_s) = decode_request(req)
                except Exception as exc:        # noqa: BLE001 — client
                    replied = True
                    self._reply_json(400, {"error":
                                           f"{type(exc).__name__}: {exc}"})
                    return
                # Overload and deadline are 503 (retryable); a failing
                # render (a build error, device memory, a bug) is ours:
                # 500.
                try:
                    img, dt, cache = svc.render(
                        mode, scene, cfg, size=size, source_image=src,
                        disk=disk, riaf=riaf, star=star,
                        deadline_s=deadline_s)
                    fmt = req.get("format", "png")
                    img = _display_encode(mode, img, fmt)
                    body, ctype = _encode_image(img, fmt)
                except Overloaded as exc:
                    replied = True
                    self._reply_json(503, {"error": "overloaded",
                                           "detail": str(exc)},
                                     extra=[("Retry-After", "1")])
                    return
                except DeadlineExceeded as exc:
                    replied = True
                    self._reply_json(503, {"error": "deadline exceeded",
                                           "detail": str(exc)})
                    return
                except Exception as exc:        # noqa: BLE001 — server
                    replied = True
                    self._reply_json(500, {"error":
                                           f"{type(exc).__name__}: {exc}"})
                    return
                replied = True
                self._reply(200, body, ctype,
                            extra=[("X-Render-Seconds", f"{dt:.4f}"),
                                   ("X-Cache", cache)])
            except (BrokenPipeError, ConnectionResetError):
                # The client went away mid-reply: nothing more to send.
                pass
            except Exception:
                if not replied:
                    try:
                        self._reply_json(500, {"error": "internal"})
                    except OSError:
                        pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.service = svc
    return server


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="light_path_tracer_tpu_torch render server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where requests render: 'cuda' runs the "
                             "hand-written CUDA kernels, 'cpu' their plain "
                             "PyTorch loops")
    parser.add_argument("--max-queue", type=int, default=4,
                        help="max requests waiting for the render lock "
                             "before 503 overloaded")
    parser.add_argument("--deadline", type=float, default=120.0,
                        help="default per-request queue-wait deadline "
                             "[s] (overridable per request via "
                             "deadline_s)")
    args = parser.parse_args(argv)
    server = make_server(args.host, args.port,
                         RenderService(max_queue=args.max_queue,
                                       default_deadline_s=args.deadline,
                                       device=args.device))
    host, port = server.server_address[:2]
    print(f"render server on http://{host}:{port} "
          f"(POST /render, GET /healthz /stats; device {args.device})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
