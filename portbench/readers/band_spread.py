"""How much longer the slowest rank's band takes than the fastest's, in %:
the largest over the smallest of the ranks' device ms a step of the
kernels a metric names, less 1. Rank 0's ms are read from the traced
window (kernel_ms), the other ranks' from the figures their own profiles
handed to the driver (ctx["raw"]["band_k6_ms"]).

params: "include" (patterns of the kernels' names, as kernel_ms takes
them). None where the driver handed over no figures of the other ranks."""
from portbench.readers import kernel_ms


def read(trace, ctx, params):
    others = (ctx.get("raw") or {}).get("band_k6_ms")
    mine = kernel_ms.read(trace, ctx, {"include": params["include"]})
    if not others or mine is None or any(x is None for x in others):
        return None
    ms = [mine, *others]
    return 100.0 * (max(ms) / min(ms) - 1.0) if min(ms) > 0 else None
