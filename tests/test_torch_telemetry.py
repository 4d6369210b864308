"""rtwc_tpu_torch's spans and counters on the CPU (utils/telemetry.py): off
and free with no profiler recording, the named `rtwc.*` ranges of a frame
and a step nested as the program opens them under torch.profiler, the
program's own record of them on the profiler's clock, the host reads of a
frame and a spawn, a capture counted, and `profiler_trace`'s counters.json."""
import contextlib
import json
import os
import re
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtwc_tpu_torch.camera import Keys
from rtwc_tpu_torch.config import EngineConfig, RenderConfig
from rtwc_tpu_torch.engine import Engine
from rtwc_tpu_torch.heads import encode as ENC
from rtwc_tpu_torch.io import FramebufferSink
from rtwc_tpu_torch.io.input import InputState
from rtwc_tpu_torch.render import step_graph as SG
from rtwc_tpu_torch.utils import profiler_trace
from rtwc_tpu_torch.utils import telemetry as T

torch.set_num_threads(2)

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "rtwc_tpu_torch")
FRAME_CHILDREN = {"frame.input", "frame.enqueue", "frame.wait", "encode", "frame.present",
                  "frame.spawn"}


class _Keys:
    """An input handler holding W, with a 1 px yaw a frame."""

    def start(self):
        pass

    def cleanup(self):
        pass

    def poll(self):
        return InputState(keys=Keys(w=1), rot_delta=(0.0, 1.0), mode=None, quit=False)


def _engine(spawn_every_frame=True):
    rcfg = RenderConfig(width=32, height=12, max_spheres=16, max_planes=4)
    ecfg = EngineConfig(show_fps=False, mouse=False, seed=1,
                        fps_update_interval_s=0.0 if spawn_every_frame else 1e9)
    eng = Engine(rcfg, ecfg, presenter=FramebufferSink(), input_handler=_Keys(),
                 interactive=False, device="cpu")
    eng.start()
    return eng


class _Stream:
    """A CUDA stream stood in for on the CPU."""

    def __init__(self, *a):
        pass

    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _cuda_standins(make_graph, capturing=contextlib.nullcontext):
    """torch.cuda's streams and graph calls stood in for on the CPU, so that
    warm_and_capture runs its bookkeeping there: make_graph() is the
    CUDAGraph, capturing() the context of a capture."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
        mp.setattr(torch.cuda, "Stream", _Stream)
        mp.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        mp.setattr(torch.cuda, "CUDAGraph", make_graph)
        mp.setattr(torch.cuda, "graph", lambda g: capturing())
        yield


class _Graph:
    """A captured step's graph stood in for on the CPU: a replay runs the
    loss and its backward into the parameter's .grad."""

    def __init__(self, p, log=None):
        self.p, self.log = p, log

    def replay(self):
        if self.log is not None:
            self.log.append("replay")
        self.p.grad = None
        (self.p * self.p).sum().backward()


def _step():
    """A CapturedStep past its capture (made on the stand-ins): each call
    replays the stand-in graph and then steps torch's default Adam
    eagerly."""
    p = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    opt = torch.optim.Adam([p], lr=0.1)
    step = SG.CapturedStep(lambda: (p * p).sum(), opt, graph=False)
    step.graph = True
    with _cuda_standins(lambda: _Graph(p)):
        step()
    return step


def _ranges(prof):
    """{name without the prefix: [(start_ns, end_ns)]} of the rtwc.* CPU ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(T.PREFIX) and "CPU" in str(e.device_type()):
            out.setdefault(e.name()[len(T.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = T.span("frame"), T.span("step.replay")
    assert a is b
    with a:
        pass
    assert T.span("encode") is a


def test_no_range_is_entered_and_nothing_recorded_without_a_profiler(monkeypatch):
    entered = []

    def spy(name):
        entered.append(name)
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    before = T.recorded()
    eng = _engine()
    for _ in range(3):
        eng.run_frame()
    eng.flush()
    _step()()
    assert entered == [] and T.recorded() == before


def test_only_telemetry_opens_profiler_ranges_in_the_port():
    """Every range of the port goes through `span` (gated on the profiler)."""
    found = []
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py") and f != "telemetry.py":
                with open(os.path.join(d, f)) as fh:
                    if re.search(r"record_function|_profiler_enabled", fh.read()):
                        found.append(f)
    assert found == []


def test_a_frame_and_a_step_emit_their_ranges_nested():
    eng = _engine()
    eng.run_frame()
    step = _step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_frame()
        step()
    r = _ranges(prof)
    native = not ENC._native_failed
    want = FRAME_CHILDREN | {"frame", "step.replay", "step.opt"} | (
        {"encode.native"} if native else set())
    assert set(r) == want
    assert all(len(v) == 1 for v in r.values())
    frame = r["frame"][0]
    for name in FRAME_CHILDREN:
        assert _inside(r[name][0], frame), name
    if native:
        assert _inside(r["encode.native"][0], r["encode"][0])
    # the step's replay after the frame, its eager Adam after the replay
    assert frame[1] <= r["step.replay"][0][0] and r["step.replay"][0][1] <= r["step.opt"][0][0]
    # the frame's parts in the order the loop runs them
    order = sorted(FRAME_CHILDREN, key=lambda n: r[n][0][0])
    assert order == ["frame.input", "frame.enqueue", "frame.wait", "encode", "frame.present",
                     "frame.spawn"]


def test_the_programs_record_is_on_the_profilers_clock():
    """Each recorded span encloses its profiler range, within a millisecond
    at either end and by under 0.2 ms at the median: one clock for the
    program's record and the trace. A warm frame and step are profiled
    first: a process's first profiled trial runs slowest."""
    eng = _engine()
    eng.run_frame()
    step = _step()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.run_frame()
        step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_frame()
        step()
    r = _ranges(prof)
    rec = T.recorded()["spans"][-sum(len(v) for v in r.values()):]
    assert sorted(n for n, _, _ in rec) == sorted(n for n, v in r.items() for _ in v)
    heads, tails = [], []
    for name, s, e in rec:
        (ks, ke), = r[name]
        assert 0 <= ks - s < 1_000_000 and 0 <= e - ke < 1_000_000, (name, ks - s, e - ke)
        heads.append(ks - s)
        tails.append(e - ke)
    assert statistics.median(heads) < 200_000 and statistics.median(tails) < 200_000


def test_a_frame_reads_the_host_once_and_a_spawn_by_its_reads():
    eng = _engine(spawn_every_frame=False)
    eng.run_frame()
    c0 = T.counters()["host_reads"]
    eng.run_frame()                 # publishes the first frame: its event wait
    assert T.counters()["host_reads"] - c0 == 1
    c0 = T.counters()["host_reads"]
    n0 = eng.scene.n_spheres
    c1 = T.counters()["host_reads"]
    assert c1 - c0 == 1
    eng._spawn()                    # n_spheres twice, six leaves to the host
    assert T.counters()["host_reads"] - c1 == 8
    assert eng.scene.n_spheres == n0 + 1


def test_recorded_marks_only_while_profiling():
    m0 = len(T.recorded()["marks"])
    T.count("test.counter", 3)
    assert len(T.recorded()["marks"]) == m0
    with profile(activities=[ProfilerActivity.CPU]):
        T.count("test.counter", 2)
    name, _, n = T.recorded()["marks"][-1]
    assert (name, n) == ("test.counter", 2) and T.counters()["test.counter"] >= 5


def test_counters_hold_the_launch_counts():
    snap = T.counters()
    for k, v in SG.launch_counts().items():
        assert snap[f"launches.{k}"] == v


def test_a_capture_is_counted_and_spanned():
    """warm_and_capture's bookkeeping with the CUDA stream and graph calls
    stood in for: one capture, one `graph.capture` span around warm and
    capture."""
    calls = []

    def capturing():
        calls.append("graph")
        return contextlib.nullcontext()

    c0 = T.counters().get("graph.captures", 0)
    with _cuda_standins(lambda: "graph", capturing), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        out = SG.warm_and_capture(lambda: calls.append("warm") or 1,
                                  lambda: calls.append("capture") or 2, torch.device("cpu"))
    assert out[0] == 1 and out[2] == 2 and out[3] == {}
    assert calls == ["warm", "graph", "capture"]
    assert T.counters()["graph.captures"] == c0 + 1
    assert list(_ranges(prof)) == ["graph.capture"]


@pytest.mark.parametrize("case", ["same key", "new key", "reset", "step"])
def test_one_capture_and_replay_mechanism(case):
    """CapturedCall on the stand-ins: a call with the key of the capture
    replays it, a new key or a call after reset() captures again; a
    CapturedStep over it opens `step.replay` and `step.opt` around a
    replay only, and `graph.capture` (counting `graph.captures`) around a
    capture only."""
    log = []
    p = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    with _cuda_standins(lambda: _Graph(p, log)):
        if case == "step":
            step = SG.CapturedStep(lambda: (p * p).sum(), torch.optim.Adam([p], lr=0.1),
                                   graph=False)
            step.graph = True
            for want in ("capture", "replay", "replay"):
                c0 = T.counters().get("graph.captures", 0)
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    loss = step()
                spans = sorted(_ranges(prof))
                if want == "capture":
                    assert spans == ["graph.capture"] and log == []
                    assert T.counters()["graph.captures"] == c0 + 1
                else:
                    assert spans == ["step.opt", "step.replay"] and log[-1] == "replay"
                    assert T.counters()["graph.captures"] == c0
                assert float(loss) == 5.0 if want == "capture" else loss.shape == ()
            assert step.captures == 1 and log == ["replay", "replay"]
            return
        runs = []
        call = SG.CapturedCall(lambda: runs.append("fn") or len(runs), "cuda", graph=True)
        # a capture returns the warm call's result, a replay the captured one's
        assert call(1) == 1 and runs == ["fn", "fn"] and call.captures == 1
        assert call.replays(1) and call(1) == 2 and log == ["replay"]
        if case == "new key":
            assert not call.replays(2)
            assert call(2) == 3 and call.replays(2) and not call.replays(1)
        elif case == "reset":
            call.reset()
            assert not call.replays(1)
            assert call(1) == 3 and call.replays(1)
        if case == "same key":
            assert call(1) == 2 and call.captures == 1 and log == ["replay", "replay"]
        else:
            assert runs == ["fn"] * 4 and call.captures == 2 and log == ["replay"]
        assert call.replay_launches == {}


def test_profiler_trace_writes_the_trace_and_the_counters(tmp_path):
    eng = _engine()
    eng.run_frame()
    with profiler_trace(str(tmp_path)):
        eng.run_frame()
        T.count("test.traced")
    counts = json.loads((tmp_path / "counters.json").read_text())
    assert counts["host_reads"] == 9          # the publish and a spawn's eight
    assert counts["test.traced"] == 1 and counts["launches.hard_render"] == 0
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"rtwc.frame", "rtwc.encode", "rtwc.frame.spawn"} <= names


def test_telemetry_ticks_once_an_interval():
    tel = T.Telemetry(update_interval_s=0.0)
    assert tel.tick() and tel.fps > 0
    assert not hasattr(tel, "rays_per_sec")
    assert not T.Telemetry(update_interval_s=1e9).tick()
