"""Host ms a unit inside a span the program opened, less the time inside
other program spans: span_ms over the program's own record of its spans
(rtwc_tpu_torch.utils.telemetry `recorded()`, kept while the profiler
traced the window, on the wall clock of the profiler's timestamps).

params: "span" (its name, without the program's "rtwc." prefix), "minus"
(names of program spans whose time is taken out). None where the program
keeps no such record or opened no such span in the window."""
from portbench.readers import span_ms, timeline


def recorded(trace: dict) -> dict:
    """The program's spans and counter marks inside the traced window:
    {"spans": [(name, start_ns, end_ns)], "marks": [(counter, t_ns, n)]},
    or None where the program keeps no record of them."""
    try:
        from rtwc_tpu_torch.utils import telemetry
    except ImportError:
        return None
    if not hasattr(telemetry, "recorded"):
        return None
    w0, w1 = timeline.window(trace)
    rec = telemetry.recorded()
    return {"spans": [x for x in rec["spans"] if w0 <= x[1] and x[2] <= w1],
            "marks": [x for x in rec["marks"] if w0 <= x[1] <= w1]}


def read(trace, ctx, params):
    rec = recorded(trace)
    if rec is None:
        return None
    return span_ms.read({"spans": rec["spans"]}, ctx, params)
