"""The port's render server (light_path_tracer_tpu_torch.serve) against
the JAX package's.

A live server on the CPU (RenderService(device="cpu"), port 0) answers
every mode at 32^2 (lens and composite with a seeded 16x24 PNG
background); each `npy` body is held against the JAX package's
render_request(req, fmt="npy") for the same JSON, in float64, at the
tolerance of that mode's existing port test:
  * shadow: the images equal on >= 99 % of pixels
    (test_torch_pipeline.py::test_render_shadow_matches_jax's masks);
  * lens (bilinear): image RMSE < 1e-3, here on every pixel
    (test_torch_render.py's render_scene criterion, there on pixels of
    winding < 2);
  * disk, composite, volumetric: max |d| < 1e-6 (test_torch_disk.py,
    test_torch_disk_composite.py, test_torch_volumetric_render.py);
  * magnification, caustics, shear (float32 maps): within 2 float32 ulps
    per pixel or 1e-9 of the largest value; timedelay (float64): within
    1e-9 relative per pixel, floored at 1e-3 of the largest value; finite
    masks equal (test_torch_lens_maps.py);
  * star: within 1e-9 of the largest value (test_torch_star.py's
    tone-mapped image) or 1 float32 ulp per pixel: the image is the
    float64 brightness cast to float32, and at this request's phase 0 one
    pixel's brightness (equal to JAX's within 6e-11 of the largest) casts
    to the neighbouring float32.
Then the error taxonomy (400 / 404 / 500 / 503 with Retry-After),
/healthz while the render lock is held, custom_metric refused, the JSON
decoders field for field as JAX's, the PNG encoder's pixels against
matplotlib's imsave (JAX's encoder), the display encodings' scalars
before the colour table bitwise JAX's, a handler thread's render bitwise
the main thread's, and `python -m light_path_tracer_tpu_torch.serve
--device cpu --port 0` starting.
"""

import base64
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import serve as jserve
from light_path_tracer_tpu_torch import serve
from light_path_tracer_tpu_torch.utils.save import encode_png, read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BG = (np.random.default_rng(5).random((16, 24, 3)) * 255).astype(np.uint8)
BG_B64 = base64.b64encode(encode_png(BG)).decode()
KERR = {"a": 0.9, "r_obs_mult": 100.0, "vertical_fov_deg": 12.0}
MAPS = {"a": 0.9, "r_obs_mult": 50.0, "vertical_fov_deg": 30.0,
        "theta_obs": 80.0}
DISK = {"a": 0.9, "theta_obs": 80.0}
F64 = {"dtype": "float64"}
SIZE = [32, 32]
REQUESTS = {
    "shadow": {"scene": KERR, "render": F64, "size": SIZE},
    "lens": {"scene": KERR, "render": dict(F64, sampling="bilinear"),
             "image_b64": BG_B64},
    "disk": {"scene": DISK, "render": F64, "size": SIZE},
    "composite": {"scene": DISK, "render": F64, "image_b64": BG_B64,
                  "disk": {"spectrum": "blackbody"}},
    "magnification": {"scene": MAPS, "render": F64, "size": SIZE},
    "caustics": {"scene": MAPS, "render": F64, "size": SIZE},
    "timedelay": {"scene": MAPS, "render": F64, "size": SIZE},
    "shear": {"scene": MAPS, "render": F64, "size": SIZE},
    "volumetric": {"scene": {"a": 0.9, "theta_obs": 80.0,
                             "vertical_fov_deg": 16.0},
                   "render": F64, "size": SIZE},
    "star": {"scene": {"a": 0.3, "theta_obs": 60.0,
                       "vertical_fov_deg": 8.0},
             "render": F64, "size": SIZE,
             "star": {"radius": 5.0, "omega": 0.05, "limb_k": 0.5,
                      "spots": [[30.0, 0.0, 20.0, 1.0],
                                [120.0, 150.0, 15.0, 0.8]]}},
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _start(svc):
    server = serve.make_server(port=0, service=svc)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"


def _stop(server):
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def server_url():
    server, url = _start(serve.RenderService(device="cpu"))
    yield url
    _stop(server)


def _post(url, payload, path="/render"):
    """(status, body, headers) of a POST; non-2xx statuses returned."""
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, err.read(), dict(err.headers)


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _npy(body):
    return np.load(io.BytesIO(body), allow_pickle=False)


def _ulps_or_max(got, want, ulps, frac):
    """Per pixel |d| <= ulps float32 ulps of JAX's value or frac of the
    largest |value|, on pixels finite in both; finite masks equal."""
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    g, w = got[fin].astype(np.float64), want[fin].astype(np.float64)
    spacing = np.spacing(np.abs(want[fin]).astype(np.float32))
    bar = np.maximum(ulps * spacing.astype(np.float64),
                     frac * np.abs(w).max())
    assert (np.abs(g - w) <= bar).all(), np.abs(g - w).max()


def _check(mode, got, want):
    assert got.shape == want.shape
    if mode == "shadow":
        assert (got == want).mean() >= 0.99
    elif mode == "lens":
        assert float(np.sqrt(np.mean((got - want) ** 2))) < 1e-3
    elif mode in ("disk", "composite", "volumetric"):
        assert np.isfinite(got).all()
        assert np.abs(got.astype(np.float64) - want).max() < 1e-6
    elif mode in ("magnification", "caustics", "shear"):
        assert got.dtype == want.dtype == np.float32
        _ulps_or_max(got, want, 2, 1e-9)
    elif mode == "timedelay":
        assert got.dtype == want.dtype == np.float64
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        scale = np.maximum(np.abs(want[fin]), 1e-3 * np.abs(want[fin]).max())
        assert (np.abs(got[fin] - want[fin]) <= 1e-9 * scale).all()
    else:
        assert mode == "star" and got.dtype == want.dtype == np.float32
        _ulps_or_max(got, want, 1, 1e-9)


@pytest.mark.parametrize("mode", list(REQUESTS))
def test_mode_npy_matches_jax_render_request(server_url, mode):
    req = dict(REQUESTS[mode], mode=mode, format="npy")
    status, body, hdr = _post(server_url, req)
    assert status == 200, body
    assert hdr["Content-Type"] == "application/octet-stream"
    assert hdr["X-Cache"] == "cold" and float(hdr["X-Render-Seconds"]) > 0
    jbody, _ctype, _dt, _cache = jserve.render_request(req, fmt="npy")
    _check(mode, _npy(body), _npy(jbody))


def test_warm_request_and_stats(server_url):
    req = dict(REQUESTS["shadow"], mode="shadow", format="npy",
               size=[16, 16])
    replies = [_post(server_url, req) for _ in range(2)]
    assert [r[2]["X-Cache"] for r in replies] == ["cold", "warm"]
    assert replies[0][1] == replies[1][1]
    status, stats = _get(server_url, "/stats")
    assert status == 200 and stats["max_queue"] == 4
    assert any(s["mode"] == "shadow" and s["count"] >= 2
               for s in stats["per_signature"])


def test_shadow_png_decodes_to_jax_png_pixels(server_url):
    req = dict(REQUESTS["shadow"], mode="shadow", format="png")
    status, body, hdr = _post(server_url, req)
    assert status == 200 and hdr["Content-Type"] == "image/png"
    jbody, jctype, _dt, _cache = jserve.render_request(req)
    assert jctype == "image/png"
    import matplotlib.image as mpimg
    want = mpimg.imread(io.BytesIO(jbody), format="png")
    np.testing.assert_array_equal(read_png(body), want)


def test_png_background_decodes_as_matplotlib_reads_it():
    import matplotlib.image as mpimg
    src = np.random.default_rng(8).random((6, 7, 4)).astype(np.float32)
    buf = io.BytesIO()
    mpimg.imsave(buf, src, format="png")
    b64 = base64.b64encode(buf.getvalue()).decode()
    np.testing.assert_array_equal(serve._decode_image(b64),
                                  jserve._decode_image(b64))
    npy = io.BytesIO()
    np.save(npy, src)
    np.testing.assert_array_equal(
        serve._decode_image(base64.b64encode(npy.getvalue()).decode()), src)


def _images():
    """2-D, RGB and RGBA arrays with NaN, values outside [0, 1], exact 0
    and 1, and values on and beside the gray table's k / 256 edges."""
    rng = np.random.default_rng(11)
    edges = np.arange(257) / 256.0
    flat = np.concatenate([edges, np.nextafter(edges, -1),
                           np.nextafter(edges, 2), [np.nan, -0.5, 1.5],
                           rng.uniform(-0.1, 1.1, 126)])
    out = []
    for dtype in (np.float32, np.float64):
        out.append(flat.astype(dtype).reshape(30, 30))
        rgb = rng.uniform(-0.1, 1.1, (9, 11, 3)).astype(dtype)
        rgb[0, 0, 1] = np.nan
        out.append(rgb)
        rgba = rng.uniform(-0.1, 1.1, (9, 11, 4)).astype(dtype)
        rgba[1, 2, 3] = np.nan
        out.append(rgba)
    return out


@pytest.mark.parametrize("index", range(6),
                         ids=[f"{k}-{d}" for d in ("f32", "f64")
                              for k in ("gray", "rgb", "rgba")])
def test_encode_image_pixels_are_jax_pixels(index):
    import matplotlib.image as mpimg
    img = _images()[index]
    body, ctype = serve._encode_image(img, "png")
    jbody, jctype = jserve._encode_image(img, "png")
    assert ctype == jctype == "image/png"
    want = mpimg.imread(io.BytesIO(jbody), format="png")
    np.testing.assert_array_equal(read_png(body), want)
    npy, nctype = serve._encode_image(img, "npy")
    assert nctype == "application/octet-stream"
    np.testing.assert_array_equal(_npy(npy), img)


def _maps(mode):
    rng = np.random.default_rng({"caustics": 1, "timedelay": 2,
                                 "shear": 3, "magnification": 4}[mode])
    shape = (5, 24, 24) if mode == "shear" else (24, 24)
    m = rng.lognormal(0.0, 2.0, shape)
    if mode in ("shear", "magnification"):
        m *= rng.choice([-1.0, 1.0], shape)
    m[..., 10:14, 10:14] = np.nan
    m[..., 0, :3] = (np.inf, -np.inf, 0.0)
    return m


@pytest.mark.parametrize("mode", ["caustics", "timedelay", "shear",
                                  "magnification"])
def test_display_encode_scalars_are_jax_scalars(monkeypatch, mode):
    """The scalar that enters the colour table (log compression, clip
    limit, the diverging shift) bitwise JAX's; non-finite pixels black."""
    import matplotlib.cm
    from light_path_tracer_tpu_torch.utils import color
    seen = {}

    def grab(side, table):
        def fn(x):
            seen[side] = (table, np.array(x, copy=True))
            return np.zeros(np.shape(x) + ((3,) if side == "port" else (4,)))
        return fn

    tables = {"caustics": "inferno", "timedelay": "viridis",
              "shear": "RdBu_r", "magnification": "RdBu_r"}
    table = tables[mode]
    monkeypatch.setattr(color, "colormap",
                        lambda name, x: grab("port", name)(x))
    monkeypatch.setattr(matplotlib.cm, table, grab("jax", table))
    m = _maps(mode)
    rgb = serve._display_encode(mode, m, "png")
    jserve._display_encode(mode, m, "png")
    assert seen["port"][0] == seen["jax"][0] == table
    np.testing.assert_array_equal(seen["port"][1], seen["jax"][1])
    bad = ~np.isfinite(m[3] if mode == "shear" else m)
    if mode == "magnification":
        bad = ~np.isfinite(np.sign(m) * np.log10(1.0 + np.abs(m)))
    assert bad.any() and (rgb[bad] == 0.0).all()
    assert serve._display_encode(mode, m, "npy") is m


def test_healthz_on_the_cpu(server_url):
    assert _get(server_url, "/healthz") == (
        200, {"ok": True, "devices": 1, "platform": "cpu"})


def test_error_taxonomy(server_url):
    """Client errors 400, unknown paths 404, render failures 500."""
    for bad in ({"mode": "nope"},
                {"mode": "shadow", "scene": {"nonsense_field": 1}},
                {"mode": "shadow", "size": [-4, 0]},
                {"mode": "shadow", "deadline_s": -1},
                {"mode": "lens"},
                {"mode": "volumetric", "riaf": {"profile": "blob"}},
                {"mode": "star", "star": {"spots": [[1.0, 2.0]]}}):
        status, body, _ = _post(server_url, bad)
        assert status == 400, bad
        assert "error" in json.loads(body)
    req = urllib.request.Request(server_url + "/render", data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req)
    assert err.value.code == 400
    assert _post(server_url, {"mode": "shadow"}, path="/nope")[0] == 404
    assert _get(server_url, "/nope") == (404, {"error": "unknown path"})

    class Broken(serve.RenderService):
        def render(self, *a, **kw):
            raise RuntimeError("device exploded")

    server, url = _start(Broken(device="cpu"))
    try:
        status, body, _ = _post(url, {"mode": "shadow", "size": [8, 8]})
        assert status == 500 and b"device exploded" in body
    finally:
        _stop(server)


def test_custom_metric_refused_over_http(server_url):
    status, body, _ = _post(server_url, {
        "mode": "shadow", "size": [16, 16],
        "scene": {"a": 0.0, "custom_metric": "evil.py:f"}})
    assert status == 400 and b"custom_metric" in body


@pytest.fixture()
def busy():
    """A server whose render lock is held, as by a long render."""
    svc = serve.RenderService(max_queue=1, default_deadline_s=0.2,
                              device="cpu")
    server, url = _start(svc)
    assert svc._lock.acquire(timeout=1.0)
    yield url, svc
    svc._lock.release()
    _stop(server)


def test_deadline_is_503(busy):
    url, _svc = busy
    t0 = time.perf_counter()
    status, body, _ = _post(url, {"mode": "shadow", "size": [16, 16],
                                  "deadline_s": 0.1})
    assert status == 503 and json.loads(body)["error"] == "deadline exceeded"
    assert time.perf_counter() - t0 < 5.0


def test_overload_is_503_with_retry_after(busy):
    url, svc = busy
    results = []
    waiter = threading.Thread(target=lambda: results.append(_post(
        url, {"mode": "shadow", "size": [8, 8], "deadline_s": 30.0})))
    waiter.start()
    for _ in range(250):
        if svc.stats()["waiting"] >= 1:
            break
        time.sleep(0.02)
    assert svc.stats()["waiting"] == 1
    status, body, headers = _post(url, {"mode": "shadow", "size": [8, 8]})
    assert status == 503 and json.loads(body)["error"] == "overloaded"
    assert headers.get("Retry-After") == "1"
    svc._lock.release()
    waiter.join(timeout=60)
    assert svc._lock.acquire(timeout=60)
    assert not waiter.is_alive() and results[0][0] == 200


def test_healthz_answers_while_the_lock_is_held(busy):
    url, _svc = busy
    t0 = time.perf_counter()
    status, health = _get(url, "/healthz")
    status2, stats = _get(url, "/stats")
    assert time.perf_counter() - t0 < 1.0
    assert status == status2 == 200 and health["ok"]
    assert stats["max_queue"] == 1


@pytest.mark.parametrize("scene", [
    {"a": 0.5, "theta_obs": 80.0, "psi_x": 2.0, "psi_y": -1.5,
     "boost": [0, 0, 0.3]},
    {"M": 2.0, "Q": 0.4, "r_obs_mult": 60, "vertical_fov_deg": 25.0,
     "boost": [0.1, -0.2, 0]},
    {}])
def test_scene_json_field_for_field_as_jax(scene):
    assert dataclasses.asdict(serve._scene_from_json(scene)) == \
        dataclasses.asdict(jserve._scene_from_json(scene))
    assert serve._scene_from_json(scene) == serve._scene_from_json(
        json.loads(json.dumps(scene)))


def test_config_json_field_for_field_as_jax():
    for port, jax_fn, d in (
            (serve._disk_cfg_from_json, jserve._disk_cfg_from_json,
             {"tilt": 30.0, "tilt_azimuth": 45.0, "warp_radius": 0,
              "spectrum": "blackbody"}),
            (serve._disk_cfg_from_json, jserve._disk_cfg_from_json,
             {"tilt": 10.0, "warp_radius": 10.0}),
            (serve._riaf_cfg_from_json, jserve._riaf_cfg_from_json,
             {"profile": "jet", "jet_beta": 0.6}),
            (serve._star_cfg_from_json, jserve._star_cfg_from_json,
             REQUESTS["star"]["star"]),
            (serve._render_cfg_from_json, jserve._render_cfg_from_json,
             {"dtype": "float64", "chunk_size": 64, "progress": "live"})):
        assert dataclasses.asdict(port(d)) == dataclasses.asdict(jax_fn(d))
    for bad in ({"profile": "shell", "shell_in": 5, "shell_out": 4},
                {"jet_beta": 1.0}):
        with pytest.raises(ValueError):
            serve._riaf_cfg_from_json(bad)


def test_handler_thread_equals_main_thread(server_url):
    """A render on the server's handler thread equals the same render on
    this thread bitwise."""
    from light_path_tracer_tpu_torch.pipeline import render_shadow
    req = dict(REQUESTS["shadow"], mode="shadow", format="npy",
               render={}, size=[24, 24])
    status, body, _ = _post(server_url, req)
    assert status == 200
    _mode, scene, cfg, *_ = serve.decode_request(req)
    img, _stats = render_shadow(scene, (24, 24), cfg, device="cpu")
    np.testing.assert_array_equal(_npy(body), img.numpy())


def test_main_starts_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "light_path_tracer_tpu_torch.serve",
         "--device", "cpu", "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("render server on http://127.0.0.1:"), line
        url = line.split()[3]
        assert _get(url, "/healthz") == (
            200, {"ok": True, "devices": 1, "platform": "cpu"})
        status, body, _ = _post(url, {"mode": "shadow", "size": [8, 8],
                                      "format": "npy"})
        assert status == 200 and _npy(body).shape == (8, 8)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_serving_modules_import_without_jax():
    """The serving shell imports neither jax nor the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['light_path_tracer_tpu'] = None; "
            "import light_path_tracer_tpu_torch.serve, "
            "light_path_tracer_tpu_torch.checkpoint, "
            "light_path_tracer_tpu_torch.version, "
            "light_path_tracer_tpu_torch.cli.app, "
            "light_path_tracer_tpu_torch.cli.request, "
            "light_path_tracer_tpu_torch.utils.progress, "
            "light_path_tracer_tpu_torch.utils.telemetry")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    from light_path_tracer_tpu.version import __version__ as jax_version
    from light_path_tracer_tpu_torch.version import __version__
    assert __version__ == jax_version


def test_concurrent_requests_keep_the_counts():
    """More client threads than cores, a short switch interval: every
    request is rendered once and counted once, nobody is left waiting,
    and each reply equals the serial one."""
    n = 2 * (os.cpu_count() or 4)
    svc = serve.RenderService(max_queue=n, device="cpu")
    server, url = _start(svc)
    req = {"mode": "shadow", "size": [8, 8], "format": "npy",
           "scene": {"a": 0.9, "r_obs_mult": 100.0}}
    want = _post(url, req)[1]
    results = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: results.append(
            _post(url, req))) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        _stop(server)
    assert len(results) == n
    assert all(r[0] == 200 and r[1] == want for r in results)
    stats = svc.stats()
    assert stats["requests"] == n + 1 and stats["waiting"] == 0
    assert stats["per_signature"][0]["count"] == n + 1
