"""A program counter of bytes, in KiB a unit over the traced window (the
counts the program recorded inside it, as counter.py reads them).

params: "counter" (its name). None where the program keeps no record of
its counts or recorded no count of that name in the window."""
from portbench.readers import program_span_ms


def read(trace, ctx, params):
    rec = program_span_ms.recorded(trace)
    if rec is None or not ctx["units"]:
        return None
    counts = [n for name, _, n in rec["marks"] if name == params["counter"]]
    return sum(counts) / 1024.0 / ctx["units"] if counts else None
