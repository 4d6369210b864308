"""The device's timeline inside the traced window: busy time, idle gaps,
kernel names."""
from __future__ import annotations

import fnmatch


def window(trace: dict):
    """(start_ns, end_ns) of the "window" span, or of all events."""
    for name, s, e in trace["spans"]:
        if name == "window":
            return s, e
    ev = trace["device"]
    return (min(x[2] for x in ev), max(x[2] + x[3] for x in ev)) if ev else (0, 0)


def intervals(trace: dict):
    """Merged [start, end) device intervals clipped to the window, sorted."""
    w0, w1 = window(trace)
    spans = sorted((max(s, w0), min(s + d, w1)) for _, _, s, d in trace["device"]
                   if s + d > w0 and s < w1)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_and_window(trace: dict):
    """(seconds some device operation ran, seconds of the window)."""
    w0, w1 = window(trace)
    return sum(e - s for s, e in intervals(trace)) / 1e9, (w1 - w0) / 1e9


def function_name(name: str) -> str:
    """A kernel's function name: the demangled name before its argument
    list, without return type, namespace or template arguments; a copy's
    or fill's name as it is."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = name.replace("(anonymous namespace)", "anon")
    depth, cut = 0, len(head)
    for i, ch in enumerate(head):          # the first '(' outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    head = head[:cut]
    while head.endswith(">"):               # drop the trailing template arguments
        depth, i = 0, len(head) - 1
        while i >= 0:
            depth += {">": 1, "<": -1}.get(head[i], 0)
            if depth == 0:
                break
            i -= 1
        head = head[:i].rstrip()
    parts = head.split()
    return parts[-1].split("::")[-1] if parts else name


def matches(name: str, patterns) -> bool:
    fn = function_name(name)
    return any(fnmatch.fnmatchcase(fn, p) or fnmatch.fnmatchcase(name, p) for p in patterns)


def _host_at(trace: dict, t: float) -> str:
    """The innermost harness span at time t (the host's activity then)."""
    best = None
    for name, s, e in trace["spans"]:
        if name != "window" and s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "outside spans"


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing, in seconds."""
    w0, w1 = window(trace)
    ops = {}
    for name, _, s, d in trace["device"]:
        if w0 <= s < w1:
            key = function_name(name)
            ops[key] = ops.get(key, 0) + d / 1e9
    merged = intervals(trace)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:top],
            "idle_gaps": [[_host_at(trace, (s + e) / 2), (e - s) / 1e9] for s, e in gaps[:top]]}
