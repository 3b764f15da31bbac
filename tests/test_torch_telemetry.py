"""The port's telemetry and progress bars (utils/telemetry.py,
utils/progress.py) and the chunked trace's progress and chunk store
(ops/batch.trace_batch), on the CPU.

  * HostTelemetry reads this process's CPU time and RSS from /proc as
    the JAX package's does (both sampled here, within the same bounds);
  * LiveBar renders in place and completes with a newline;
    chunk_iterator for False, True (tqdm) and "live";
  * device_memory() is {} without CUDA; profile() writes a Chrome trace;
  * trace_batch with progress="live" and a chunk store equals the run
    without them bitwise in float64 and float32, and a second run takes
    every chunk from the store (on the rays' device) bitwise too;
  * --progress bar|live maps to RenderConfig.progress as the JAX CLI's
    _render_cfg_from maps it, and `shadow --progress live --chunk-size`
    runs.
"""

import contextlib
import io
import json
import math
import os

import numpy as np
import pytest
import torch

from light_path_tracer_tpu.utils import telemetry as jtelemetry
from light_path_tracer_tpu_torch.checkpoint import ChunkStore
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.utils import telemetry
from light_path_tracer_tpu_torch.utils.progress import LiveBar, chunk_iterator


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_host_telemetry_reads_proc_as_jax():
    ours, theirs = telemetry.HostTelemetry(), jtelemetry.HostTelemetry()
    _ = sum(i * i for i in range(200000))
    for s in (ours.sample(), theirs.sample()):
        assert s["wall_s"] > 0 and s["cpu_s"] >= 0
        assert s["rss_mib"] > 10
        assert s["peak_rss_mib"] >= s["rss_mib"] - 1
    assert set(ours.sample()) == set(theirs.sample())
    mem, jmem = ours.memory(), theirs.memory()
    assert abs(mem["peak_rss_mib"] - jmem["peak_rss_mib"]) < 64


def test_live_bar_renders_and_completes():
    buf = io.StringIO()
    bar = LiveBar(4, desc="Test", stream=buf, min_interval=0.0)
    for i in range(4):
        bar.update(i + 1)
    out = buf.getvalue()
    assert out.count("\r") == 4 and out.endswith("\n")
    assert "4/4" in out and "cpu" in out and "MiB" in out
    assert "[" in out and "#" in out


def test_live_bar_throttles_until_done():
    buf = io.StringIO()
    bar = LiveBar(3, stream=buf, min_interval=3600.0)
    for i in range(3):
        bar.update(i + 1)
    out = buf.getvalue()
    assert out.count("\r") == 2 and "3/3" in out and out.endswith("\n")


@pytest.mark.parametrize("progress", [False, True, "live"])
def test_chunk_iterator(progress):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = list(chunk_iterator(range(0, 30, 10), progress))
    assert got == [0, 10, 20]
    if progress == "live":
        assert "3/3" in err.getvalue()
    elif progress is False:
        assert err.getvalue() == ""


def test_device_memory_and_profile(tmp_path):
    assert not torch.cuda.is_available()
    assert telemetry.device_memory() == {}
    with telemetry.profile(str(tmp_path)) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path)
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as fh:
        assert "traceEvents" in json.load(fh)


def _rays(dtype):
    rng = np.random.default_rng(7)
    m = Kerr(M=1.0, a=0.9)
    ac = m.alpha_crit(100.0)
    al = torch.tensor(rng.uniform(0.5 * ac, 3.0 * ac, 300), dtype=dtype)
    th = torch.tensor(rng.uniform(-math.pi, math.pi, 300), dtype=dtype)
    rf = torch.tensor(rng.random(300) < 0.2)
    return m, al, th, rf


class _Counting(ChunkStore):
    def __init__(self, *a):
        super().__init__(*a)
        self.gets = self.hits = self.puts = 0

    def get(self, start):
        res = super().get(start)
        self.gets += 1
        self.hits += res is not None
        return res

    def put(self, start, res):
        self.puts += 1
        super().put(start, res)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trace_batch_progress_and_store_bitwise(tmp_path, dtype):
    m, al, th, rf = _rays(dtype)
    kw = dict(chunk_size=96, max_steps=20000)
    plain = trace_batch(m, 100.0, al, th, math.pi / 2, rf, **kw)
    store = _Counting(str(tmp_path), "k")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        live = trace_batch(m, 100.0, al, th, math.pi / 2, rf,
                           progress="live", chunk_store=store, **kw)
    assert "4/4" in err.getvalue() and err.getvalue().endswith("\n")
    assert (store.gets, store.hits, store.puts) == (4, 0, 4)
    assert sorted(store.chunk_starts()) == [0, 96, 192, 288]
    again = trace_batch(m, 100.0, al, th, math.pi / 2, rf,
                        chunk_store=store, **kw)
    assert (store.gets, store.hits, store.puts) == (8, 4, 4)
    for res in (live, again):
        for a, b in zip(res, plain):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(torch.nan_to_num(a, nan=-7.0),
                               torch.nan_to_num(b, nan=-7.0))
    store.clear()
    assert store.chunk_starts() == []


def test_progress_flag_maps_as_jax():
    from light_path_tracer_tpu_torch.cli import build_parser
    from light_path_tracer_tpu_torch.cli._shared import _render_cfg_from
    parser = build_parser()
    for flag, want in (("off", False), ("bar", True), ("live", "live")):
        args = parser.parse_args(["shadow", "--progress", flag])
        assert _render_cfg_from(args).progress == want


def test_shadow_cli_with_live_progress(tmp_path, capsys):
    from light_path_tracer_tpu_torch.cli import main
    out = tmp_path / "s.png"
    assert main(["shadow", "--a", "0.9", "--size", "16", "--fov-v", "12",
                 "--chunk-size", "64", "--progress", "live", "--device",
                 "cpu", "--output", str(out)]) == 0
    cap = capsys.readouterr()
    assert "2/2" in cap.err and f"Saved: {out}" in cap.out
