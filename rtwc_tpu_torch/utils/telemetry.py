"""Runtime telemetry: rendering FPS, the port's spans and counters, and an
optional profiler trace.

Counterpart: rtwc_tpu/utils/telemetry.py:14-50; `profiler_trace` uses
torch.profiler (CPU activity, plus CUDA when a card is present) and
writes a Chrome trace into the given directory.

Spans. `span(name)` marks where the program spends its host time (the
frame's input, enqueue, wait and present, the encode, a step's replay).
While a torch profiler records (`profiler_trace`, or any
`torch.profiler.profile` around the program), it is a
`torch.profiler.record_function` range named "rtwc." + name, so the
program's spans sit in the profiler's trace on the clock of its kernel
records, and the program keeps its own record of it, `recorded()`:
(name, start_ns, end_ns) on `time.time_ns()`, the wall clock the
profiler's timestamps are on, taken just outside the range. With no
profiler recording it is one shared null context: a span then costs
under a microsecond, and no range is entered. No span is opened inside a
CUDA graph capture.

Counters. `count(name, n)` adds to the program's one registry of counts;
`counters()` snapshots it together with the kernel modules' launch
counters and K6's tile counts (registered as sources, `add_source`: they
keep their own names; K6's are read from the card, so `counters()` is
never called inside a step). While a profiler records, each count is
also kept in `recorded()` as (name, t_ns, n), so a reader of a traced
window counts what fell inside it. `profiler_trace` writes the counters' change over
its region to counters.json beside the trace.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Callable

import torch

PREFIX = "rtwc."
RECORD_LIMIT = 1 << 18  # spans and counts kept a kind; the oldest go first

_NULL = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}
_SOURCES: list[Callable[[], dict]] = []
_SPANS: collections.deque = collections.deque(maxlen=RECORD_LIMIT)
_MARKS: collections.deque = collections.deque(maxlen=RECORD_LIMIT)


class _Span:
    """A record_function range named PREFIX + name, kept in `_SPANS` on exit."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.time_ns()
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        _SPANS.append((self.name, self._t0, time.time_ns()))
        return False


def span(name: str):
    """A context over a span of the program's host time: a profiler range
    while a torch profiler records, else the shared null context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n
    if torch.autograd._profiler_enabled():
        _MARKS.append((name, time.time_ns(), n))


def add_source(source: Callable[[], dict]) -> None:
    """Register a function returning counters kept elsewhere, read by every
    `counters()`. Its users are render/step_graph.py, for the kernel
    modules' `LAUNCHES` dicts, and render/shadow_kernel.py, for K6's tiles
    by class (a read of a card's buffer): utils imports nothing of render,
    so render registers them here rather than `counters()` reading them
    itself."""
    _SOURCES.append(source)


def counters() -> dict:
    """A snapshot of every counter of the program, by name."""
    out = dict(_COUNTS)
    for source in _SOURCES:
        out.update(source())
    return out


def recorded() -> dict:
    """What the program recorded while a profiler recorded: {"spans":
    [(name, start_ns, end_ns)], "marks": [(counter, t_ns, n)]}, names
    without the prefix, on time.time_ns()."""
    return {"spans": list(_SPANS), "marks": list(_MARKS)}


class Telemetry:
    def __init__(self, update_interval_s: float = 1.0):
        self.interval = update_interval_s
        self._frames = 0
        self._t0 = time.perf_counter()
        self.fps = 0.0

    def tick(self) -> bool:
        """Count one frame; True once per interval (the 1 Hz edge the
        engine uses for FPS publication and sphere spawning)."""
        self._frames += 1
        now = time.perf_counter()
        elapsed = now - self._t0
        if elapsed >= self.interval:
            self.fps = self._frames / elapsed
            self._frames = 0
            self._t0 = now
            return True
        return False


@contextlib.contextmanager
def profiler_trace(dir: str | None):
    """Profile the region with torch.profiler when a directory is given and
    write <dir>/trace.json (Chrome trace format, the program's spans as
    "rtwc." ranges) and <dir>/counters.json (each counter's change over
    the region)."""
    if not dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir, exist_ok=True)
    before = counters()
    with profile(activities=activities) as prof:
        yield
    after = counters()
    prof.export_chrome_trace(os.path.join(dir, "trace.json"))
    with open(os.path.join(dir, "counters.json"), "w") as f:
        json.dump({k: v - before.get(k, 0) for k, v in sorted(after.items())}, f, indent=1)
