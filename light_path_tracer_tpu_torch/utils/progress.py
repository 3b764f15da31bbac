"""Live ANSI progress bar with host telemetry for chunked tracing.

The counterpart of `light_path_tracer_tpu.utils.progress`: an in-place
bar over the chunk loop of ops/batch.trace_batch, adapted to the
terminal's width, with the CPU utilization and current / peak RSS of
utils.telemetry.HostTelemetry. RenderConfig(progress="live") selects it;
progress=True a plain tqdm bar (tqdm is imported only then, and raises
its ImportError where it is not installed).
"""

from __future__ import annotations

import shutil
import sys
import time

from light_path_tracer_tpu_torch.utils.telemetry import HostTelemetry


class LiveBar:
    """In-place ANSI bar: [####----] i/n  elapsed  CPU%  RSS/peak MiB."""

    def __init__(self, total: int, desc: str = "Tracing",
                 stream=None, min_interval: float = 0.1):
        self.total = max(int(total), 1)
        self.desc = desc
        self.stream = stream if stream is not None else sys.stderr
        self.telemetry = HostTelemetry()
        self.t0 = time.monotonic()
        self.min_interval = min_interval
        self._last = 0.0
        self._done = 0

    def update(self, done: int):
        self._done = done
        now = time.monotonic()
        if done < self.total and now - self._last < self.min_interval:
            return
        self._last = now
        self.stream.write("\r" + self._line())
        if done >= self.total:
            self.stream.write("\n")
        self.stream.flush()

    def _line(self) -> str:
        sample = self.telemetry.sample()
        elapsed = time.monotonic() - self.t0
        frac = min(self._done / self.total, 1.0)
        stats = (f" {self._done}/{self.total}"
                 f" {elapsed:6.1f}s"
                 f" cpu {sample['cpu_util'] * 100.0:5.1f}%"
                 f" rss {sample['rss_mib'] or 0.0:7.1f}"
                 f"/{sample['peak_rss_mib'] or 0.0:7.1f} MiB")
        width = shutil.get_terminal_size(fallback=(80, 24)).columns
        # Whatever the stats and label leave over, at least 8 columns.
        bar_w = max(width - len(self.desc) - len(stats) - 4, 8)
        filled = int(round(frac * bar_w))
        bar = "#" * filled + "-" * (bar_w - filled)
        return f"{self.desc} [{bar}]{stats}"


def chunk_iterator(starts, progress, desc="Tracing per-pixel rays"):
    """Wrap a chunk-start iterable per the `progress` setting:
    False -> as-is; True -> tqdm; "live" -> LiveBar (ANSI + telemetry)."""
    starts = list(starts)
    if progress == "live":
        bar = LiveBar(len(starts), desc=desc)

        def gen():
            for i, s in enumerate(starts):
                yield s
                bar.update(i + 1)

        return gen()
    if progress:
        from tqdm import tqdm
        return tqdm(starts, desc=desc, unit="chunk")
    return iter(starts)
