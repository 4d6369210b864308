"""Frame timer (Timer.h/.cpp). Counterpart: rtwc_tpu/utils/timer.py:7-24."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._start = time.perf_counter()
        self._last = self._start
        self._dt = 0.0

    def update(self) -> None:
        now = time.perf_counter()
        self._dt = now - self._last
        self._last = now

    @property
    def delta_time(self) -> float:
        return self._dt

    @property
    def since_start(self) -> float:
        return time.perf_counter() - self._start
