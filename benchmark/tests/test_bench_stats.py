"""The window's arithmetic: rates over every call and the whole window,
the tail over every call, and the spread that sets a bound."""

import pytest

from benchmark.harness import spec, stats
from benchmark.harness.runner import Call


def reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py",
                            f"test_metric_{name}")


def window(durations, steps=100, samples=1, gap=0.0):
    calls, t = [], 0.0
    for d in durations:
        calls.append(Call(t, t + d, steps, samples))
        t += d + gap
    return {"calls": calls, "window_s": calls[-1].end - calls[0].begin}


def test_rate_and_tail_of_steady_calls():
    run = window([0.01] * 100)
    assert reader("steps_per_s").read(run) == pytest.approx(10000.0)
    assert reader("call_ms_p99").read(run) == pytest.approx(10.0)
    run = window([0.02] * 10, steps=200, samples=16)
    assert reader("sample_steps_per_s").read(run) == pytest.approx(160000.0)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    steady = window([0.01] * 100)
    stalled = window([0.01] * 94 + [0.2] * 6)
    assert reader("steps_per_s").read(stalled) < \
        0.6 * reader("steps_per_s").read(steady)
    assert reader("call_ms_p99").read(stalled) == pytest.approx(200.0)
    # a stall between calls, inside the window, lowers the rate too
    gapped = window([0.01] * 100, gap=0.01)
    assert reader("steps_per_s").read(gapped) == pytest.approx(
        10000.0 * 100 * 0.01 / (100 * 0.01 + 99 * 0.01))


def test_nearest_rank_percentile():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3


def test_spread_is_the_quartile_distance_over_the_median():
    values = [90.0, 95.0, 100.0, 105.0, 110.0, 100.0]
    import statistics

    q1, _, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / 100.0)
