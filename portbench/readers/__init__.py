"""Readers of per-layer metrics. Each module has read(trace, ctx, params)
-> a number, or None where the trace holds nothing to read.

trace: {"device": [(name, kind, start_ns, dur_ns)], "spans": [(name,
start_ns, end_ns)]}, kind one of kernel, gpu_memcpy, gpu_memset; the span
"window" bounds the traced window. ctx: {"units": steps or frames in the
window, "work": {kernel: (bytes, operations)}, "raw": what the driver's
window returned}.
"""
