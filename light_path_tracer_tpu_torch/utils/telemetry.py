"""Profiling and live telemetry.

The counterpart of `light_path_tracer_tpu.utils.telemetry`:

  * `profile(log_dir)` — a torch.profiler trace (host and CUDA
    activities) around a block, written into `log_dir` as a Chrome trace
    (open it in chrome://tracing or Perfetto);
  * `device_memory()` — each visible CUDA device's allocator statistics
    (torch.cuda.memory_stats), with `bytes_in_use` and
    `peak_bytes_in_use` named as the JAX package names them; `{}` where
    CUDA is not available;
  * `HostTelemetry` — RSS / peak-RSS / CPU-time sampling of this process
    from /proc (Linux), as the JAX package reads them.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile(log_dir: str = "lpt_profile"):
    """torch.profiler trace around a block; the Chrome trace goes to
    `log_dir` (trace_<pid>_<ns>.json)."""
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory():
    """Per-device memory statistics (bytes) of the CUDA caching allocator,
    keyed "cuda:i": torch.cuda.memory_stats(i) with `bytes_in_use` (its
    allocated_bytes.all.current) and `peak_bytes_in_use`
    (allocated_bytes.all.peak) added. {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = dict(torch.cuda.memory_stats(i))
        stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current",
                                              0))
        stats["peak_bytes_in_use"] = int(stats.get(
            "allocated_bytes.all.peak", 0))
        out[f"cuda:{i}"] = stats
    return out


class HostTelemetry:
    """Process CPU-time and memory sampling from /proc (Linux)."""

    def __init__(self):
        self._clk = os.sysconf("SC_CLK_TCK")
        self._t0 = time.monotonic()
        self._cpu0 = self._cpu_seconds()

    def _cpu_seconds(self) -> float:
        with open(f"/proc/{os.getpid()}/stat") as f:
            fields = f.read().split()
        utime, stime = int(fields[13]), int(fields[14])
        return (utime + stime) / self._clk

    def memory(self) -> dict:
        """Current and peak RSS in MiB from /proc/self/status."""
        rss = peak = None
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) / 1024.0
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) / 1024.0
        return {"rss_mib": rss, "peak_rss_mib": peak}

    def sample(self) -> dict:
        """CPU utilization since construction + memory snapshot."""
        wall = max(time.monotonic() - self._t0, 1e-9)
        cpu = self._cpu_seconds() - self._cpu0
        out = {"wall_s": wall, "cpu_s": cpu, "cpu_util": cpu / wall}
        out.update(self.memory())
        return out
