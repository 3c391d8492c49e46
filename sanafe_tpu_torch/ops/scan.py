"""The step scan: a chunk of timesteps, one ``_timestep`` after another.

Counterpart of ``sanafe_tpu/ops/step.py:DeviceProgram.make_scan`` in its
named-output form (``wire=False``): ``lax.scan`` becomes a Python loop whose
every op runs on the program's device, and the per-step outputs are stacked
along a leading time axis. The outputs have the names, dtypes and shapes of
sanafe_tpu's scan:

- ``stats`` [T, 11] program dtype: spike_ops, packets, hops, updated, fired,
  synapse/dendrite/soma/network/total energy, simple-timing sim_time;
- ``opt_perf`` [T, n_opt] when the chip logs perf columns;
- ``spike_log_packed`` [T, ceil(S/8)] uint8 when spikes are logged and the
  masks are not recorded;
- ``potential_log`` [T, P] and ``u_log`` [T, U];
- ``masks_packed`` [T, 2, ceil(N/8)] uint8: the fired and updated masks.

Fused-roll-up programs without dense delivery emit the fired/updated planes
from the loop and run one batched roll-up after it (``rollup_stats``, shared
with the DAG engine of ``ops/dag_chunk.py``), as sanafe_tpu does. With a device sweep (``make_scan(device_sweep=True)``: the
merge sweep of ``ops/merge_sweep.py``), the sweep runs after the loop on the
chunk's masks, still on the device, and adds

- ``sim_device`` [T] program dtype: each step's detailed-timing sim_time;
- ``sweep_overflow`` [T] bool: the steps the host must sweep instead.

The mask wire and the sparse spike wire of ``make_scan`` worked around the
TPU's host link and are not ported (ROADMAP.md section 1, "Not ported").

A chunk of ``make_scan`` is one compiled XLA program. Here a program with
``graph`` set (``make_device_program``: on CUDA by default) runs its chunk
as CUDA graphs (``ScanGraphs``): ``GRAPH_UNROLL`` consecutive steps are
captured once into one ``torch.cuda.CUDAGraph`` and the chunk replays it,
so a step's few dozen ops and kernel launches cost the host one replay a
block instead of a Python call each. The captured code is the code the
eager loop runs (``steps``, over the step tensor ``t``), and its outputs
are the same bits. The deferred roll-up and the device sweep run after the
replays, eagerly, as in the eager loop. A sharded program stays eager.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import tracing
from .conv import full_float32_matmul
from .dag_chunk import rollup_stats
from .device_sweep import unpack_masks
from .graphs import Captured, capture, replay
from .step import DeviceProgram, _timestep

# Steps a captured graph holds: sanafe_tpu's unroll for fused-roll-up
# chips (sanafe_tpu/ops/step.py:474-486). A chunk replays it
# ceil(length / GRAPH_UNROLL) times; a shorter remainder is a second graph.
GRAPH_UNROLL = 16


def steps(prog: DeviceProgram, a: dict, state: dict, t: torch.Tensor,
          feeds: dict, count: int, defer_rollup: bool):
    """``count`` consecutive steps from the 1-based step ``t`` (a 0-d
    int64 tensor on the program's device), the step's feeds being row
    ``i`` of each ``[count, k]`` tensor of ``feeds``: the new state and the
    steps' outputs stacked along a leading ``[count]`` axis. The eager scan
    calls it once a chunk, and ``ScanGraphs`` captures it for a block."""
    outputs: dict[str, list] = {}
    for i in range(count):
        state, out = _timestep(prog, a, state, t + i,
                               {key: value[i] for key, value in feeds.items()},
                               defer_rollup=defer_rollup)
        for key, value in out.items():
            outputs.setdefault(key, []).append(value)
    return state, {key: torch.stack(values)
                   for key, values in outputs.items()}


class ScanGraphs:
    """The step scan of one program as CUDA graphs of ``GRAPH_UNROLL``
    steps.

    Static buffers hold the state, the step tensor and ``GRAPH_UNROLL``
    rows of each feed; a graph reads them, writes its outputs into buffers of its
    own and ends by copying the new state into the static state and
    advancing the step. ``run`` copies a chunk's state in once, replays
    ``ceil(length / GRAPH_UNROLL)`` times (a shorter last block replays a second
    graph), copies each replay's outputs into the chunk's ``[T, ...]``
    tensors with one copy an output, and copies the state out once. Each
    block size is captured at its first use: that block runs eagerly on a
    side stream first (the warm-up, whose results are kept), then is
    captured (``ops/graphs.py:capture``). A capture or replay error
    raises. Each block is a ``sanafe.replay`` span (``sanafe.capture`` at
    its capture) with the children ``sanafe.replay.feeds``, ``.launch``
    and ``.outputs`` (``tracing.py``). The launch counters stay true
    (``ops/graphs.py``); ``replays`` counts the replays.

    On the CPU the blocks run eagerly, in the same form (the same buffers
    and copies), so the CPU tests run the code the card captures. Built
    once with the program's engine (``chip.py``) or sweep (``batch.py``),
    whose rebuild drops it."""

    def __init__(self, prog: DeviceProgram, arrays: dict):
        self.prog = prog
        self.arrays = arrays
        self.defer_rollup = prog.fused_rollup and not prog.dense_delivery
        self.capture = prog.device.type == "cuda"
        self.state: Optional[dict] = None
        self.feeds: Optional[dict] = None
        self.t = torch.zeros((), dtype=torch.int64, device=prog.device)
        self.blocks: dict[int, Captured] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.replays = 0

    def run(self, state: dict, t0: int, length: int, feeds: dict):
        """``length`` steps from step ``t0``: the state after them (tensors
        of their own) and the stacked per-step outputs, as the eager
        loop's. ``feeds`` holds the chunk's ``[length, k]`` device feeds."""
        self._load(state, feeds)
        self.t.fill_(t0)
        outputs: dict[str, torch.Tensor] = {}
        for lo in range(0, length, GRAPH_UNROLL):
            count = min(GRAPH_UNROLL, length - lo)
            first = self.capture and count not in self.blocks
            with tracing.span("sanafe.capture" if first else "sanafe.replay",
                              engine="scan", steps=count):
                with tracing.span("sanafe.replay.feeds"):
                    for key, buf in self.feeds.items():
                        buf[:count].copy_(feeds[key][lo:lo + count])
                with tracing.span("sanafe.replay.launch"):
                    block = self._block(count)
                with tracing.span("sanafe.replay.outputs"):
                    for key, value in block.items():
                        if key not in outputs:
                            outputs[key] = torch.empty(
                                (length,) + tuple(value.shape[1:]),
                                dtype=value.dtype, device=value.device)
                        outputs[key][lo:lo + count].copy_(value)
        return {key: value.clone() for key, value in self.state.items()}, \
            outputs

    def _load(self, state: dict, feeds: dict) -> None:
        """Copy ``state`` into the static state (made at the first chunk),
        and make the static feed rows at the first chunk; a state or feed
        of another layout than the first raises."""
        if self.state is None:
            self.state = {key: torch.empty_like(value)
                          for key, value in state.items()}
            self.feeds = {key: torch.empty(
                (GRAPH_UNROLL,) + tuple(value.shape[1:]), dtype=value.dtype,
                device=value.device) for key, value in feeds.items()}
        layout = {key: (value.shape, value.dtype)
                  for key, value in self.state.items()}
        if layout != {key: (value.shape, value.dtype)
                      for key, value in state.items()}:
            raise ValueError("ScanGraphs: the state does not match the "
                             "layout its graphs were built for")
        if set(feeds) != set(self.feeds) or any(
                feeds[key].shape[1:] != buf.shape[1:]
                or feeds[key].dtype != buf.dtype
                for key, buf in self.feeds.items()):
            raise ValueError("ScanGraphs: the feeds do not match the layout "
                             "its graphs were built for")
        for key, value in state.items():
            self.state[key].copy_(value)

    def _body(self, count: int) -> dict:
        """The block the graph captures: ``count`` steps over the static
        buffers; returns the steps' stacked outputs."""
        new_state, outputs = steps(
            self.prog, self.arrays, dict(self.state), self.t,
            {key: buf[:count] for key, buf in self.feeds.items()}, count,
            self.defer_rollup)
        if set(new_state) != set(self.state):
            raise ValueError("ScanGraphs: the step returned state keys "
                             f"{sorted(new_state)}, not {sorted(self.state)}")
        for key, value in new_state.items():
            self.state[key].copy_(value)
        self.t.add_(count)
        return outputs

    def _block(self, count: int) -> dict:
        """Run one block of ``count`` steps: eagerly on the CPU; on the
        card a replay, or at the block size's first use the warm-up and
        the capture."""
        if not self.capture:
            return self._body(count)
        block = self.blocks.get(count)
        if block is not None:
            self.replays += 1
            return replay(block)
        outputs, self.blocks[count] = capture(
            lambda: self._body(count), self.prog.device, self.pool)
        return outputs


def run_scan(prog: DeviceProgram, state: dict, t0: int, length: int,
             feeds: Optional[dict] = None, sweep: Optional[Callable] = None,
             graphs: Optional[ScanGraphs] = None,
             arrays: Optional[dict] = None):
    """Run ``length`` timesteps from 1-based step ``t0``: returns the state
    after the last step and the named per-step outputs (module docstring),
    all on the program's device. ``feeds`` holds the host inputs of the
    chunk as ``[length, k]`` arrays (``tn_noise``, ``poisson``); a sharded
    program (``parallel``) takes the columns of its own neurons. A plugin
    model with a chunk feed (``models.register_soma_model(feed=)``) draws
    its chunk here. ``sweep`` (a ``make_merge_sweep`` function; the program
    must record the masks) sweeps the chunk's steps on the device.

    A program with ``graph`` set runs through ``graphs`` (its engine's
    ``ScanGraphs``; one made for this call where None), any other in one
    eager call of ``steps``. ``arrays`` (default ``prog.arrays``) are the
    device arrays the step reads: a sweep's, with its overrides."""
    dev = prog.device
    a = prog.arrays if arrays is None else arrays
    defer_rollup = prog.fused_rollup and not prog.dense_delivery
    shard = prog.shard
    cols = shard.feed_cols if shard is not None else {}
    chunk_feeds = {
        key: torch.as_tensor(np.asarray(value)[:, cols[key]]
                             if key in cols else np.asarray(value)).to(dev)
        for key, value in (feeds or {}).items()
    }
    local = shard.arrays if shard is not None else a
    lanes = (range(shard.lo, shard.hi) if shard is not None
             else range(prog.compiled.n_neurons))
    for spec in prog.compiled.plugin_specs:
        if spec.feed is None:
            continue
        rows = spec.feed({param: local[f"plugin_{spec.name}_{param}"]
                          for param in spec.param_defaults}, t0, length,
                         lanes)
        if rows is not None:
            chunk_feeds[f"plugin_{spec.name}"] = torch.as_tensor(rows).to(
                device=dev, dtype=prog.dtype)
    with full_float32_matmul():
        if not length:
            outputs = {}
        elif prog.graph:
            if graphs is None:
                graphs = ScanGraphs(prog, a)
            state, outputs = graphs.run(state, t0, length, chunk_feeds)
        else:
            t = torch.tensor(t0, dtype=torch.int64, device=dev)
            state, outputs = steps(prog, a, state, t, chunk_feeds, length,
                                   defer_rollup)
        if defer_rollup and length:
            fired_pl = outputs.pop("fired_plane")
            upd_pl = outputs.pop("upd_plane")
            stats, opt_perf = rollup_stats(
                prog, a, fired_pl.to(prog.dtype), upd_pl.to(prog.dtype)
            )
            outputs["stats"] = stats
            if opt_perf is not None:
                outputs["opt_perf"] = opt_perf
    if sweep is not None and length:
        fired, updated = unpack_masks(outputs["masks_packed"],
                                      sweep.n_neurons)
        outputs["sim_device"], outputs["sweep_overflow"] = sweep(fired,
                                                                 updated)
    return state, outputs
