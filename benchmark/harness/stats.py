"""Window arithmetic: rates over the whole window and tails over every
call, and the spread that sets a bound."""

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(calls, per_call, window_s: float) -> float:
    """Units of every call that completed in the window over the window's
    wall time, ``per_call(call)`` giving a call's units."""
    if window_s <= 0:
        raise ValueError("empty window")
    return sum(per_call(c) for c in calls) / window_s


def spread(values) -> float:
    """The distance between the first and third quartiles (Python's
    ``statistics.quantiles``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
