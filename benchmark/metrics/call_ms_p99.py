"""The 99th percentile (nearest rank) of the wall time of every call in
the window, each ended by torch.cuda.synchronize()."""

from benchmark.harness.stats import percentile


def read(run: dict):
    return 1e3 * percentile([c.end - c.begin for c in run["calls"]], 99)
