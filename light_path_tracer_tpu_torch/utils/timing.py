"""Per-stage wall-clock instrumentation.

CUDA work is asynchronous: a stage is only done when the device has run
what the stage enqueued. So when the timer's device is a CUDA device,
`stage()` calls `torch.cuda.synchronize` on it before stopping the clock.
"""

from __future__ import annotations

import contextlib
from time import perf_counter

import torch


class StageTimer:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.timings: dict[str, float] = {}
        self._total_start = perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        start = perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[name] = self.timings.get(name, 0.0) + (
                perf_counter() - start)

    def finish(self):
        self.timings["total"] = perf_counter() - self._total_start
        return self.timings
