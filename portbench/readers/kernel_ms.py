"""Device ms a unit (step or frame) of the kernels a metric names.

params: "include" (patterns of kernel function names; absent: every
kernel), "exclude" (patterns left out). Patterns are fnmatch patterns of
the function name or the full name. Only kernels count, not copies."""
from portbench.readers import timeline


def read(trace, ctx, params):
    w0, w1 = timeline.window(trace)
    inc, exc = params.get("include"), params.get("exclude", [])
    total, found = 0, False
    for name, kind, s, d in trace["device"]:
        if kind != "kernel" or not w0 <= s < w1:
            continue
        if (inc is None or timeline.matches(name, inc)) and not timeline.matches(name, exc):
            total += d
            found = True
    if not found or not ctx["units"]:
        return None
    return total / 1e6 / ctx["units"]
