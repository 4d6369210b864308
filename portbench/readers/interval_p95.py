"""95th percentile, in ms, of the intervals between the units that the
traced window completed: raw["times"] holds the window's start and then
each unit's end, and the interval from the start to the first unit is
left out."""
import statistics


def read(trace, ctx, params):
    times = ctx["raw"].get("times", [])
    gaps = [(b - a) * 1e3 for a, b in zip(times[1:], times[2:])]
    if len(gaps) < 2:
        return None
    return statistics.quantiles(gaps, n=100, method="inclusive")[94]
