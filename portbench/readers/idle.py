"""Share of the traced window in which no device operation ran, in %."""
from portbench.readers import timeline


def read(trace, ctx, params):
    busy, window = timeline.busy_and_window(trace)
    if not trace["device"] or window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
