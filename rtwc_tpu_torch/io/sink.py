"""Headless frame sink for tests and measurements.

Counterpart: rtwc_tpu/io/sink.py:7-36 (a copy: importing the JAX
package's io/ runs io/input.py, which imports JAX). Same producer
interface as ConsolePresenter.
"""
from __future__ import annotations


class FramebufferSink:
    """Collects published frames in memory (optionally only the last)."""

    def __init__(self, keep_all: bool = False):
        self.keep_all = keep_all
        self.frames: list[bytes] = []
        self.last: bytes = b""
        self.render_fps = 0.0
        self._running = False

    def start(self) -> None:
        self._running = True

    def cleanup(self) -> None:
        self._running = False

    def check_if_running(self) -> bool:
        return self._running

    def set_data_in_back_buffer(self, frame: bytes) -> None:
        self.last = frame
        if self.keep_all:
            self.frames.append(frame)

    def update_rendering_fps(self, fps: float) -> None:
        self.render_fps = fps

    @property
    def printing_fps(self) -> float:
        return 0.0
