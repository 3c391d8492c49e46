"""The host's time per CUDA-graph replay: the mean duration of the
program's ``sanafe.replay`` spans in the traced window, in ms. A span
covers one replay of the step scan's 16-step graph (``ops/scan.py:
ScanGraphs``: the feed rows in, the replay, the outputs out) or of a DAG
chunk's graph (``ops/dag_chunk.py:DagGraphs``). One reader for
``replay.host_ms.sim`` and ``.sweep``; None without spans."""

from benchmark.harness import spans


def read(run: dict):
    found = spans.named(run, "sanafe.replay")
    if found is None:
        return None
    return spans.total_ms(found) / len(found)
