"""Runtime telemetry: rendering FPS, rays/s, and an optional profiler trace.

Counterpart: rtwc_tpu/utils/telemetry.py:14-50; `profiler_trace` uses
torch.profiler (CPU activity, plus CUDA when a card is present) and
writes a Chrome trace into the given directory.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class Telemetry:
    def __init__(self, rays_per_frame: int, update_interval_s: float = 1.0):
        self.rays_per_frame = rays_per_frame
        self.interval = update_interval_s
        self._frames = 0
        self._t0 = time.perf_counter()
        self.fps = 0.0
        self.rays_per_sec = 0.0

    def tick(self) -> bool:
        """Count one frame; True once per interval (the 1 Hz edge the
        engine uses for FPS publication and sphere spawning)."""
        self._frames += 1
        now = time.perf_counter()
        elapsed = now - self._t0
        if elapsed >= self.interval:
            self.fps = self._frames / elapsed
            self.rays_per_sec = self.fps * self.rays_per_frame
            self._frames = 0
            self._t0 = now
            return True
        return False


@contextlib.contextmanager
def profiler_trace(dir: str | None):
    """Profile the region with torch.profiler when a directory is given and
    write <dir>/trace.json (Chrome trace format)."""
    if not dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(dir, "trace.json"))
