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
from the loop and run one batched roll-up after it (``rollup_stats``), as
sanafe_tpu does. The mask wire, the sparse spike wire and the device sweep
of ``make_scan`` are not ported (ROADMAP.md section 1, "Not ported", and
section 2, kernel 2).

Every step launches a few dozen small ops, so a small chip is bound by
launch overhead here; capturing the step in a CUDA graph is later work.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .step import DeviceProgram, _timestep


def rollup_stats(prog: DeviceProgram, a, fired_f, upd_f):
    """Batched fused roll-up (sanafe_tpu/ops/dag_chunk.py:rollup_stats): ONE
    ``[T, 2N] @ [2N, K]`` product gives every per-step counter, energy and
    per-core latency sum (column layout: ``build_rollup_matrix``), then the
    simple-timing step time as the max over the per-core latency sums
    (src/schedule.cpp:61-102). Returns ``(stats [T, 11], opt_perf or
    None)``."""
    lhs = torch.cat([fired_f, upd_f], dim=1)
    r = lhs @ a["rollup_matrix"] + a["rollup_const"][None]
    n_cores = prog.compiled.n_cores
    lat0, msg0 = 9, 9 + n_cores
    opt0 = msg0 + n_cores
    total_energy = r[:, 5] + r[:, 6] + r[:, 7] + r[:, 8]
    sim_time = torch.maximum(
        r[:, lat0:msg0].max(dim=1).values,
        r[:, msg0:opt0].max(dim=1).values,
    ) + prog.sync_t
    stats = torch.cat(
        [r[:, :9], total_energy[:, None], sim_time[:, None]], dim=1
    )
    opt_perf = r[:, opt0:] if "perf_col_fired" in a else None
    return stats, opt_perf


@contextlib.contextmanager
def _full_float32_matmul():
    """The roll-up and one-hot products run in full float32, as XLA runs
    them: TF32 stays off for their duration."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def run_scan(prog: DeviceProgram, state: dict, t0: int, length: int,
             feeds: Optional[dict] = None):
    """Run ``length`` timesteps from 1-based step ``t0``: returns the state
    after the last step and the named per-step outputs (module docstring),
    all on the program's device. ``feeds`` holds the host inputs of the
    chunk as ``[length, k]`` arrays (``tn_noise``, ``poisson``)."""
    dev = prog.device
    a = prog.arrays
    defer_rollup = prog.fused_rollup and not prog.dense_delivery
    chunk_feeds = {
        key: torch.as_tensor(np.asarray(value)).to(dev)
        for key, value in (feeds or {}).items()
    }
    steps: dict[str, list] = {}
    with _full_float32_matmul():
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
    return state, outputs
