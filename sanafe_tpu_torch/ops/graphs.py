"""Capture and replay of CUDA graphs, shared by the step scan's
``ops/scan.py:ScanGraphs`` and the DAG engine's ``ops/dag_chunk.py:
DagGraphs``.

A graph is captured at the first use of its size: the body runs eagerly on
a side stream first (the warm-up, whose results the caller keeps), then
once more under ``torch.cuda.graph``, whose outputs are the graph's static
tensors. A capture or replay error raises; nothing falls back to eager.

The kernel wrappers count their launches in Python, which a replay does
not run. So a graph keeps the counts its capture added, takes them back
from the counters, and adds them again at every replay.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import chunk, delivery, device_sweep, level_scan, merge_sweep, neuron

# The kernel wrappers' launch counters (module, wrapper name), read through
# the module so that a wrapper replaced by a caller is still counted
_COUNTED = ((chunk, "chunk_kernel"), (delivery, "delivery_kernel"),
            (delivery, "delivery_batch_kernel"),
            (merge_sweep, "merge_kernel"), (level_scan, "level_kernel"),
            (device_sweep, "prefix_kernel"), (neuron, "neuron_kernel"))


def launch_counts() -> list:
    return [getattr(module, name).launches for module, name in _COUNTED]


def add_launches(deltas) -> None:
    for (module, name), delta in zip(_COUNTED, deltas):
        getattr(module, name).launches += delta


class Captured(NamedTuple):
    """One captured graph: its static outputs and the launch counts its
    capture saw, added back at each replay."""

    graph: torch.cuda.CUDAGraph
    outputs: object
    launches: list


def capture(body: Callable, device, pool) -> tuple:
    """Run ``body()`` eagerly on a side stream (the warm-up), then capture
    it into a graph in ``pool``. Returns the warm-up's results and the
    ``Captured`` graph, whose launch counts are taken back."""
    side = torch.cuda.Stream(device)
    current = torch.cuda.current_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        outputs = body()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        captured = body()
    deltas = [after - was for after, was in zip(launch_counts(), before)]
    add_launches([-delta for delta in deltas])
    return outputs, Captured(graph, captured, deltas)


def replay(block: Captured):
    """Replay ``block`` on the current stream, count its launches and
    return its static outputs."""
    block.graph.replay()
    add_launches(block.launches)
    return block.outputs
