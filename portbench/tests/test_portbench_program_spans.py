"""The readers of the program's own spans and counts (rtwc_tpu_torch's
utils/telemetry): hand-computed values on a synthetic record and trace,
nothing read where the program keeps no record, the program's device-side
markers kept out of the device timeline; on the card, the program's spans
and the kernels on one clock."""
from __future__ import annotations

import statistics
import time

import pytest
import torch

from portbench import harness
from portbench.readers import (counter, idle, idle_under, interval_p95, kernel_ms,
                               program_span_ms, span_ms, timeline)
from rtwc_tpu_torch.utils import telemetry

MS = 1_000_000
# Read on an H100's host over some 3900 spans of the three cells, run back
# to back: a record opens 3.9-13.4 us (medians) before its range and closes
# at most 15 us after it; a single record opened up to 0.35 ms before its
# range, a host pause between the clock read and the range's entry. After a wait for the device
# and a sleep, entering a range took about 0.1 ms (median of five replays).
CLOCK_SLACK_NS = 50_000
SMALL = {"fit_step": {"render": {"width": 64, "height": 32}},
         "console_frame": {"render": {"width": 48, "height": 16}}}


def _trace():
    dev = [("void soft_sh_mse_kernel<2>(SoftParams, float const*)", "kernel", 10 * MS, 3 * MS),
           ("tile_lists_kernel(ListParams, float const*)", "kernel", 50 * MS, 2 * MS),
           ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 54 * MS, 6 * MS),
           ("outside", "kernel", 200 * MS, MS)]
    spans = [("window", 0, 100 * MS), ("encode", 9 * MS, 15 * MS)]
    return {"device": dev, "spans": spans}


RECORD = {"spans": [("encode.native", 11 * MS, 13 * MS), ("encode", 10 * MS, 14 * MS),
                    ("encode.native", 51 * MS, 55 * MS), ("encode", 50 * MS, 56 * MS),
                    ("frame.input", 2 * MS, 3 * MS), ("encode", 150 * MS, 160 * MS)],
          "marks": [("host_reads", 5 * MS, 1), ("host_reads", 20 * MS, 1),
                    ("host_reads", 60 * MS, 8), ("graph.captures", 61 * MS, 1),
                    ("host_reads", 150 * MS, 1)]}


@pytest.fixture
def record(monkeypatch):
    monkeypatch.setattr(telemetry, "recorded", lambda: RECORD)


def test_program_span_ms_on_a_synthetic_record(record):
    tr, ctx = _trace(), {"units": 2}
    assert program_span_ms.read(tr, ctx, {"span": "encode.native"}) == (2 + 4) / 2
    # the encode less its native part; the span past the window left out
    assert program_span_ms.read(tr, ctx, {"span": "encode", "minus": ["encode.native"]}) \
        == (4 + 6 - 6) / 2
    assert program_span_ms.read(tr, ctx, {"span": "frame.input"}) == 0.5
    assert program_span_ms.read(tr, ctx, {"span": "step.replay"}) is None


def test_idle_under_a_program_span(record):
    tr, ctx = _trace(), {"units": 2}
    # encode 10-14 ms over a kernel 10-13: 1 ms idle; 50-56 over 50-52 and 54-60: 2 ms
    assert idle_under.read(tr, ctx, {"span": "encode"}) == (1 + 2) / 2
    assert idle_under.read(tr, ctx, {"span": "frame.input"}) == 0.5
    assert idle_under.read(tr, ctx, {"span": "step.replay"}) is None
    assert idle_under.read({**tr, "device": []}, ctx, {"span": "encode"}) is None


def test_counter_over_the_window(record):
    tr, ctx = _trace(), {"units": 2}
    assert counter.read(tr, ctx, {"counter": "host_reads"}) == 10 / 2
    assert counter.read(tr, ctx, {"counter": "graph.captures"}) == 0.5
    assert counter.read(tr, ctx, {"counter": "absent"}) == 0.0


def test_nothing_read_from_a_program_without_a_record(monkeypatch):
    """A program that keeps no record of its spans and counts (the parent of
    the change that added them) gives no reading and raises nothing."""
    monkeypatch.delattr(telemetry, "recorded")
    tr, ctx = _trace(), {"units": 2}
    assert program_span_ms.read(tr, ctx, {"span": "encode"}) is None
    assert idle_under.read(tr, ctx, {"span": "encode"}) is None
    assert counter.read(tr, ctx, {"counter": "host_reads"}) is None


class _Event:
    def __init__(self, name, device, start, dur, annotation=False):
        self._v = (name, device, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _events(program: bool):
    ev = [_Event("portbench.window", "CPU", 0, 100 * MS),
          _Event("portbench.window", "CUDA", 1 * MS, 99 * MS, True),
          _Event("portbench.encode", "CPU", 9 * MS, 6 * MS),
          _Event("void soft_sh_mse_kernel<2>(SoftParams, float const*)", "CUDA", 10 * MS, 3 * MS),
          _Event("tile_lists_kernel(ListParams, float const*)", "CUDA", 50 * MS, 2 * MS),
          _Event("Memcpy DtoH (Device -> Pinned)", "CUDA", 54 * MS, 6 * MS),
          _Event("aten::add", "CPU", 20 * MS, MS)]
    if program:
        ev += [_Event("rtwc.frame.enqueue", "CPU", 8 * MS, 3 * MS),
               _Event("rtwc.frame.enqueue", "CUDA", 10 * MS, 3 * MS, True),
               _Event("rtwc.step.replay", "CUDA", 49 * MS, 12 * MS, True),
               _Event("rtwc.encode", "CPU", 10 * MS, 4 * MS)]
    return ev


def test_program_markers_change_no_reading():
    """The device-side markers of the program's ranges stay out of the device
    timeline, and its host ranges out of the harness's spans: every reader
    and the breakdown read the same with them as without."""
    with_p, without = (harness.kineto_trace(_Prof(_events(p))) for p in (True, False))
    assert with_p == without
    assert not any(n.startswith(telemetry.PREFIX) for n, *_ in with_p["device"])
    ctx = {"units": 2, "work": {}, "raw": {"times": [0.0, 0.01, 0.02, 0.04]}}
    for reader, params in [(idle, {}), (kernel_ms, {}), (span_ms, {"span": "encode"}),
                           (interval_p95, {})]:
        assert reader.read(with_p, ctx, params) == reader.read(without, ctx, params)
    assert timeline.breakdown(with_p) == timeline.breakdown(without)


def _program_ranges(prof):
    """[(name without the prefix, start_ns, end_ns)] of the program's host ranges."""
    return sorted((e.name()[len(telemetry.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(telemetry.PREFIX) and "CPU" in str(e.device_type()))


def clock_offsets(prof):
    """[(name, range start - record start, record end - range end)] in ns,
    of the profiler's `rtwc.*` ranges against the program's record of the
    same spans (its last ones)."""
    ranges = _program_ranges(prof)
    rec = sorted(telemetry.recorded()["spans"][-len(ranges):])
    assert [r[0] for r in rec] == [r[0] for r in ranges]
    return [(n, ks - s, e - ke) for (n, s, e), (_, ks, ke) in zip(rec, ranges)]


def _same_clock(prof) -> list:
    """Each record of the program encloses its profiler range, closes at
    most CLOCK_SLACK_NS after it and opens at most ten times that before
    it: the two are one clock. Returns the offsets."""
    offsets = clock_offsets(prof)
    for name, head, tail in offsets:
        assert 0 <= head <= 10 * CLOCK_SLACK_NS and 0 <= tail <= CLOCK_SLACK_NS, (name, head, tail)
    return offsets


@pytest.mark.card
def test_replays_and_their_spans_on_one_clock(card):
    """A few replayed steps of `.shadowed_mse`, each waited for and 2 ms
    apart: the kernels of each replay start after its `step.replay` range
    opens and before the next one's, on the profiler's one timeline; no
    program name among the device's events; no capture in the window."""
    from torch.profiler import ProfilerActivity, profile

    cell = "fit_1080p_s20.shadowed_mse"
    config, traffic = harness.cell_files(cell)
    c = harness.driver(traffic["kind"]).make(harness.merged(config, SMALL["fit_step"]),
                                             traffic, 7, "cuda")
    captures = telemetry.counters().get("graph.captures", 0)
    c.setup()
    assert telemetry.counters()["graph.captures"] > captures
    captures = telemetry.counters()["graph.captures"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            c.step()
            torch.cuda.synchronize()
            time.sleep(0.002)
    c.release()
    assert telemetry.counters()["graph.captures"] == captures
    tr = harness.kineto_trace(prof)
    assert not any(n.startswith(telemetry.PREFIX) for n, *_ in tr["device"])
    replays = [(s, e) for n, s, e in _program_ranges(prof) if n == "step.replay"]
    assert len(replays) == 5
    kernels = sorted(s for _, kind, s, _ in tr["device"] if kind == "kernel")
    bounds = [s for s, _ in replays] + [float("inf")]
    for i in range(5):
        mine = [k for k in kernels if bounds[i] <= k < bounds[i + 1]]
        assert mine, i
    assert kernels[0] >= replays[0][0]
    _same_clock(prof)


@pytest.mark.card
def test_traced_frames_on_the_card(card):
    """A few traced frames of `.bit_pixel` at a small size after its warm-up:
    the frame's ranges, none among the device's events, one host read a
    frame besides a spawn's, no capture."""
    from torch.profiler import ProfilerActivity, profile

    cell = "console_hires.bit_pixel"
    config, traffic = harness.cell_files(cell)
    c = harness.driver(traffic["kind"]).make(harness.merged(config, SMALL["console_frame"]),
                                             traffic, 7, "cuda")
    c.setup()
    before = telemetry.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            c.engine.run_frame()
        torch.cuda.synchronize()
    after = telemetry.counters()
    c.release()
    assert after["graph.captures"] == before["graph.captures"]
    reads = after["host_reads"] - before["host_reads"]
    assert reads >= 8 and reads % 8 == 0        # a publish a frame, eight a spawn
    tr = harness.kineto_trace(prof)
    assert not any(n.startswith(telemetry.PREFIX) for n, *_ in tr["device"])
    ranges = _program_ranges(prof)
    names = {n for n, _, _ in ranges}
    assert {"frame", "frame.input", "frame.enqueue", "frame.wait", "encode", "encode.native",
            "frame.present"} <= names
    # frames back to back, as in a traced window: a record opens near its range
    assert statistics.median(h for _, h, _ in _same_clock(prof)) <= CLOCK_SLACK_NS
