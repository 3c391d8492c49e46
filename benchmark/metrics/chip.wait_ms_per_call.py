"""The host blocked on the card a call: the ``sanafe.book.wait`` spans of
the traced window (``SpikingChip.sim`` waiting for each chunk's copy to
host memory), summed, in ms over the traced calls; None without spans."""

from benchmark.harness import spans


def read(run: dict):
    found = spans.named(run, "sanafe.book.wait")
    if found is None:
        return None
    return spans.total_ms(found) / len(run["calls"])
