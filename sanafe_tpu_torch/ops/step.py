"""Device program: the compiled chip's per-step arrays as torch tensors.

Counterpart of ``sanafe_tpu/ops/step.py`` for the port's slice, which runs
only the whole-chunk engine (``ops/chunk.py``). It keeps what that engine
reads: the eligibility facts ``plan_chunk`` checks, the trace-recording
flags, the synchronisation delay, and the input-train, LIF-noise,
TrueNorth-noise and Poisson arrays that ``build_planes`` turns into
per-step planes. The XLA step scan of ``sanafe_tpu`` (``_timestep``) is not
ported yet (ROADMAP.md section 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..compile import CompiledChip

# Budgets sanafe_tpu/ops/step.py:make_device_program applies before it folds
# the per-neuron roll-up and the dense delivery columns into one matrix; the
# port decides dense delivery by the same rule so the two packages agree on
# which chips the whole-chunk engine takes.
ROLLUP_BUDGET_BYTES = 48 << 20
DENSE_DELIVERY_BUDGET_BYTES = 8 << 20


@dataclass
class DeviceProgram:
    """Compiled chip + the per-step arrays the chunk engine reads."""

    compiled: CompiledChip
    dtype: torch.dtype
    device: torch.device
    arrays: dict[str, torch.Tensor]
    record_fired_axons: bool
    record_potentials: bool
    record_spikes: bool
    record_u: bool
    sync_delay: float
    # Statically known set of soma model ids present on this chip
    models_present: frozenset = frozenset()
    # True when message delivery + the stats roll-up fit one dense matvec
    # (every dendrite a plain accumulator, and the matrix within budget)
    dense_delivery: bool = False
    # which engine ran this program's chunks ("chunk_kernel"/"chunk_plain")
    engine: str | None = None

    def init_state(self) -> dict[str, torch.Tensor]:
        c = self.compiled
        n = c.n_neurons
        dev = self.device
        return {
            "potential": torch.as_tensor(
                np.asarray(c.initial_potential), dtype=self.dtype
            ).to(dev),
            "input_current": torch.zeros(n, dtype=self.dtype, device=dev),
            "refractory": torch.zeros(n, dtype=torch.int32, device=dev),
            "buffer_current": torch.zeros(n, dtype=self.dtype, device=dev),
            "buffer_valid": torch.zeros(n, dtype=torch.bool, device=dev),
        }


def _dense_delivery(c: CompiledChip) -> bool:
    """sanafe_tpu's rule for folding delivery into the roll-up matvec
    (ops/step.py:958-978), with its float32 byte budgets."""
    if c.has_delay_dendrite or c.has_multitap or c.has_plugin_comp:
        return False  # per-edge dendrite state: no block delivery at all
    if c.neuron_proc_lat_core is None:
        return False
    n_stats_cols = 9 + 2 * c.n_cores + len(c.perf_col_names)
    if 2 * c.n_neurons * n_stats_cols * 4 > ROLLUP_BUDGET_BYTES:
        return False
    return (
        2 * c.n_neurons * (n_stats_cols + 2 * c.n_neurons) * 4
        <= DENSE_DELIVERY_BUDGET_BYTES
    )


def make_device_program(
    compiled: CompiledChip,
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
    record_fired_axons: bool = False,
    record_potentials: bool = False,
    record_spikes: bool = False,
    record_u: bool = False,
) -> DeviceProgram:
    c = compiled
    device = torch.device(device)

    def iarr(x, dt=torch.int64):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    arrays = {
        "input_train_start": iarr(c.input_train_start),
        "input_train_len": iarr(c.input_train_len),
        "input_train_stride": iarr(c.input_train_stride),
        "input_train_rank": iarr(c.input_train_rank),
        "input_rate_interval": iarr(c.input_rate_interval),
        "input_trains": iarr(
            c.input_trains if c.input_trains.size
            else np.zeros(1, dtype=bool),
            torch.bool,
        ),
    }
    if c.lif_noise_values is not None and np.any(c.lif_noise_len > 0):
        arrays["lif_noise_start"] = iarr(c.lif_noise_start)
        arrays["lif_noise_len"] = iarr(c.lif_noise_len)
        arrays["lif_noise_stride"] = iarr(c.lif_noise_stride)
        arrays["lif_noise_rank"] = iarr(c.lif_noise_rank)
        arrays["lif_noise_values"] = iarr(c.lif_noise_values, dtype)
    if c.tn_noise_slots is not None and len(c.tn_noise_slots):
        arrays["tn_noise_slots"] = iarr(c.tn_noise_slots)
    if c.has_poisson:
        arrays["poisson_slots"] = iarr(
            np.concatenate([members for _, members in c.input_units])
        )
    return DeviceProgram(
        compiled=c,
        dtype=dtype,
        device=device,
        arrays=arrays,
        record_fired_axons=record_fired_axons,
        record_potentials=record_potentials,
        record_spikes=record_spikes,
        record_u=record_u,
        sync_delay=c.arch.ts_sync_delay_table.get(c.mapped_tiles),
        models_present=frozenset(int(m) for m in np.unique(c.soma_model)),
        dense_delivery=_dense_delivery(c),
    )
