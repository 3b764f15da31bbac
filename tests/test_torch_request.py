"""The port's offline replay of serve-style requests (serve.render_request
and the `request` CLI) on the CPU: the mirror of tests/test_request.py,
plus the replay held against the JAX package's for the same JSON and
`request --image file.png` (the background read by utils/save.read_png).

Criteria: the shadow npy body equal to a direct render_shadow call
bitwise, and to JAX's on >= 99 % of pixels (test_torch_pipeline.py's
masks); the CLI's body bytes equal to render_request's for the same
request; the lens replay of a PNG file equal bitwise to the same request
with the PNG sent as image_b64.
"""

import base64
import io
import json

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import serve as jserve
from light_path_tracer_tpu_torch.cli import main
from light_path_tracer_tpu_torch.serve import (RenderService, decode_request,
                                               render_request)
from light_path_tracer_tpu_torch.utils.save import encode_png, write_png

CPU = RenderService(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _npy(body):
    return np.load(io.BytesIO(body), allow_pickle=False)


def test_render_request_shadow_png():
    body, ctype, dt, cache = render_request(
        {"mode": "shadow", "size": [24, 24], "scene": {"a": 0.6}},
        svc=RenderService(device="cpu"))
    assert ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
    assert cache == "cold" and dt > 0


def test_render_request_npy_matches_direct_render_and_jax():
    from light_path_tracer_tpu_torch.pipeline import render_shadow
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    req = {"mode": "shadow", "size": [24, 24], "scene": {"a": 0.6},
           "format": "npy"}
    body, ctype, _dt, _cache = render_request(req, svc=CPU)
    assert ctype == "application/octet-stream"
    got = _npy(body)
    want, _stats = render_shadow(SceneConfig(a=0.6), (24, 24),
                                 RenderConfig(), device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    jbody, _c, _d, _k = jserve.render_request(req)
    assert (got == _npy(jbody)).mean() >= 0.99


def test_render_request_warm_cache_on_shared_service():
    svc = RenderService(device="cpu")
    req = {"mode": "shadow", "size": [24, 24]}
    _b, _c, _d, cache0 = render_request(req, svc=svc)
    _b, _c, _d, cache1 = render_request(req, svc=svc)
    assert (cache0, cache1) == ("cold", "warm")


def test_render_request_lens_with_source_image_override():
    src = np.random.default_rng(0).uniform(
        size=(16, 16, 3)).astype(np.float32)
    body, ctype, *_ = render_request(
        {"mode": "lens", "scene": {"r_obs_mult": 100.0}}, svc=CPU,
        source_image=src)
    assert ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"


def test_decode_request_rejects_missing_lens_image():
    with pytest.raises(KeyError):
        decode_request({"mode": "lens"})


def test_decode_request_rejects_bad_mode_and_custom_metric():
    with pytest.raises(ValueError):
        decode_request({"mode": "warp-drive"})
    with pytest.raises(ValueError):
        decode_request({"mode": "shadow",
                        "scene": {"custom_metric": "x.py:f"}})
    with pytest.raises(ValueError):
        decode_request({"mode": "shadow", "size": [0, 24]})


def test_decode_request_returns_numpy_on_the_host():
    png = encode_png(np.zeros((4, 6, 3), np.uint8))
    out = decode_request({"mode": "lens",
                          "image_b64": base64.b64encode(png).decode()})
    assert isinstance(out[6], np.ndarray) and out[6].shape == (4, 6, 3)


def test_cli_request_roundtrip(tmp_path, capsys):
    req = tmp_path / "req.json"
    payload = {"mode": "shadow", "size": [24, 24]}
    req.write_text(json.dumps(payload))
    for name in ("out.png", "out.npy"):
        out = tmp_path / name
        assert main(["request", str(req), "--output", str(out),
                     "--device", "cpu"]) == 0
        fmt = name.rsplit(".", 1)[1]
        body, *_ = render_request(payload, svc=RenderService(device="cpu"),
                                  fmt=fmt)
        assert out.read_bytes() == body
    text = capsys.readouterr().out
    assert "Rendered mode=shadow in" in text and "Saved:" in text


def test_cli_request_bad_mode_exits(tmp_path):
    req = tmp_path / "req.json"
    req.write_text(json.dumps({"mode": "nope"}))
    with pytest.raises(SystemExit):
        main(["request", str(req), "--output", str(tmp_path / "x.png"),
              "--device", "cpu"])


def test_cli_request_image_file(tmp_path):
    """`request --image file.png` replaces image_b64, and equals the same
    request with the file's bytes sent as image_b64."""
    rng = np.random.default_rng(3)
    png = tmp_path / "bg.png"
    write_png(png, (rng.random((12, 16, 3)) * 255).astype(np.uint8))
    payload = {"mode": "lens", "scene": {"a": 0.0, "r_obs_mult": 100.0,
                                         "vertical_fov_deg": 20.0}}
    req = tmp_path / "req.json"
    req.write_text(json.dumps(payload))
    out = tmp_path / "lens.npy"
    assert main(["request", str(req), "--image", str(png), "--output",
                 str(out), "--device", "cpu"]) == 0
    got = _npy(out.read_bytes())
    assert got.shape == (12, 16, 3) and np.isfinite(got).all()
    b64 = base64.b64encode(png.read_bytes()).decode()
    body, *_ = render_request(dict(payload, image_b64=b64), svc=CPU,
                              fmt="npy")
    np.testing.assert_array_equal(got, _npy(body))
