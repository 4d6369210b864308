"""Host ms a unit inside a harness span, less the time inside other spans.

params: "span" (its name), "minus" (names of spans whose time is taken
out, each counted where it lies inside the span)."""


def read(trace, ctx, params):
    outer = [(s, e) for n, s, e in trace["spans"] if n == params["span"]]
    if not outer or not ctx["units"]:
        return None
    total = sum(e - s for s, e in outer)
    inner = [(s, e) for n, s, e in trace["spans"] if n in params.get("minus", [])]
    for s0, e0 in outer:
        total -= sum(max(0, min(e, e0) - max(s, s0)) for s, e in inner)
    return total / 1e6 / ctx["units"]
