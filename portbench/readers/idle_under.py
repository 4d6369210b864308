"""Device idle ms a unit inside a program span: the span's time less the
device's busy intervals (timeline.intervals, merged) that fall inside it,
summed over the window's spans of that name.

params: "span" (a program span's name, without the "rtwc." prefix). None
where the program keeps no record of its spans, opened none of that name
in the window, or the trace holds no device activity."""
import bisect

from portbench.readers import program_span_ms, timeline


def read(trace, ctx, params):
    rec = program_span_ms.recorded(trace)
    if rec is None or not trace["device"] or not ctx["units"]:
        return None
    spans = [(s, e) for n, s, e in rec["spans"] if n == params["span"]]
    if not spans:
        return None
    busy = timeline.intervals(trace)
    starts = [s for s, _ in busy]
    idle = 0
    for s0, e0 in spans:
        covered = 0
        for s, e in busy[max(0, bisect.bisect_right(starts, s0) - 1):]:
            if s >= e0:
                break
            covered += max(0, min(e, e0) - max(s, s0))
        idle += (e0 - s0) - covered
    return idle / 1e6 / ctx["units"]
