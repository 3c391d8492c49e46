"""Trace booking a simulated step: the ``sanafe.book.traces`` spans of the
traced window (``SpikingChip.sim`` writing each chunk's spike, potential
and perf rows), summed, in ms over the traced calls' steps; None without
spans."""

from benchmark.harness import spans


def read(run: dict):
    found = spans.named(run, "sanafe.book.traces")
    if found is None:
        return None
    return spans.total_ms(found) / sum(c.steps for c in run["calls"])
