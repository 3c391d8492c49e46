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

Every step launches a few dozen small ops, so a small chip is bound by
launch overhead here; capturing the step in a CUDA graph is later work.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .conv import full_float32_matmul
from .dag_chunk import rollup_stats
from .device_sweep import unpack_masks
from .step import DeviceProgram, _timestep


def run_scan(prog: DeviceProgram, state: dict, t0: int, length: int,
             feeds: Optional[dict] = None, sweep: Optional[Callable] = None):
    """Run ``length`` timesteps from 1-based step ``t0``: returns the state
    after the last step and the named per-step outputs (module docstring),
    all on the program's device. ``feeds`` holds the host inputs of the
    chunk as ``[length, k]`` arrays (``tn_noise``, ``poisson``); a sharded
    program (``parallel``) takes the columns of its own neurons. ``sweep``
    (a ``make_merge_sweep`` function; the program must record the masks)
    sweeps the chunk's steps on the device."""
    dev = prog.device
    a = prog.arrays
    defer_rollup = prog.fused_rollup and not prog.dense_delivery
    cols = prog.shard.feed_cols if prog.shard is not None else {}
    chunk_feeds = {
        key: torch.as_tensor(np.asarray(value)[:, cols[key]]
                             if key in cols else np.asarray(value)).to(dev)
        for key, value in (feeds or {}).items()
    }
    steps: dict[str, list] = {}
    with full_float32_matmul():
        for j in range(length):
            step_feeds = {key: value[j] for key, value in chunk_feeds.items()}
            state, out = _timestep(prog, a, state, t0 + j, step_feeds,
                                   defer_rollup=defer_rollup)
            for key, value in out.items():
                steps.setdefault(key, []).append(value)
        outputs = {key: torch.stack(values) for key, values in steps.items()}
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
