"""A layer's share of its bound, in %: the least time the layer's frozen
work a unit (step or frame; reference/work.py) can take on the card, over
the device time a unit of every launch of the layer's kernels in the
traced window. A kernel split into several launches, or fused with
another, reads against the same work.

params: "include" (patterns of the layer's kernel names, as kernel_ms
takes them), "work" (the key of the cell's work counts a unit)."""
from portbench.readers import kernel_ms
from portbench.reference.work import bound_ms


def read(trace, ctx, params):
    ms = kernel_ms.read(trace, ctx, {"include": params["include"]})
    work = ctx["work"].get(params["work"])
    if ms is None or work is None:
        return None
    return 100.0 * bound_ms(*work)[0] / ms
