"""A program counter's count a unit over the traced window: the counts
that the program recorded (rtwc_tpu_torch.utils.telemetry `count`, kept
with their time while the profiler traced) inside the window.

params: "counter" (its name). None where the program keeps no record of
its counts."""
from portbench.readers import program_span_ms


def read(trace, ctx, params):
    rec = program_span_ms.recorded(trace)
    if rec is None or not ctx["units"]:
        return None
    return sum(n for name, _, n in rec["marks"] if name == params["counter"]) / ctx["units"]
