"""Batched design-space exploration: B parameterizations of one chip at once.

Counterpart of ``sanafe_tpu/batch.py``. SANA-FE exists for neuromorphic
architecture design-space exploration (the TCAD'25 paper sweeps hardware
energy/latency costs and model parameters across runs). The reference
evaluates one parameterization per process; here a leading sample axis
runs B parameter samples of the SAME mapped chip through one step
(``ops/step.py:_timestep``, written to take the axis, where sanafe_tpu
``jax.vmap``s it), so

- connectivity (block weights, conv filters) stays shared and is read from
  device memory once per step for ALL samples: block delivery goes through
  ``delivery_batch_kernel`` (``csrc/delivery_batch_kernel.cu``) on CUDA,
  which reads each fired weight row that holds an edge (the live rows,
  listed once per sweep) once and adds it into every sample that fired
  it, and
- every overridden per-neuron parameter or cost column carries a
  ``[B, ...]`` axis through the same step the single-chip simulator runs,
  so batched counters are exactly those of B sequential ``sim()`` calls
  (float sums may differ in the last ulp).

Restrictions, as in sanafe_tpu: the simple timing model only, and no
host-fed stochastic models (TrueNorth LFSR noise, Poisson inputs).

Plugin somas sweep like the built-in models, with their parameters under
sanafe_tpu's device-array names ``plugin_<model>_<param>``. As in
sanafe_tpu, the initial state is the compiled chip's, built once and
broadcast over the samples: a shared-unit plugin's members are
pre-advanced with the compiled parameters, not the swept ones. NeuroFEM's
membrane noise is drawn once a step and shared by every sample, as
sanafe_tpu's ``vmap`` shares its per-step key.

``mesh`` (a one-dimensional ``torch.distributed`` ``DeviceMesh``) splits
the samples over its ranks, as sanafe_tpu splits them over a device mesh:
every rank builds the sweep with the same arguments, runs its share of the
samples (its own live-row list), and the ``[B]`` results are gathered with
one ``all_reduce`` (each sample's values come whole from one rank, zeros
elsewhere, so the gather is exact).

Overrides use sanafe_tpu's array names and layouts, so one override dict
drives both packages: a ``conv_kernel_i`` override is the HWIO filter
with the all-ones count channel last, permuted to the port's OIHW here
(``ops/conv.py:hwio_to_oihw``). Where the program delivers through the
kernel, which holds the blocks' live rows alone, ``block_weights`` and
``block_counts`` overrides (the dense blocks) are compacted to the rows live
in any sample, the counts packed into arrival words
(``ops/delivery.py:LiveRowBlocks.batch_plan``).

Example::

    chip = st.SpikingChip(arch); chip.load(net)
    sweep = ParameterSweep(chip, {
        "threshold": thresholds,          # [B, n_neurons]
        "leak_decay": decays,             # [B, n_neurons]
    })
    out = sweep.run(1000)
    best = int(np.argmin(out["energy"]["total"]))
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import tracing
from .ops.conv import hwio_to_oihw
from .ops.scan import ScanGraphs, run_scan
from .ops.step import initial_state, make_device_program

__all__ = ["ParameterSweep", "expand_group_values"]

# Pure state-dynamics parameters stay runtime inputs of the fused roll-up
# program; any other override (a cost column, the edge weights) turns
# fusion off, as in sanafe_tpu/batch.py:118-128
DYNAMICS_ONLY = frozenset({
    "threshold", "reverse_threshold", "reset", "reverse_reset",
    "leak_decay", "input_decay", "bias", "leak",
    "leak_towards_zero", "refractory_delay", "force_update",
})


def expand_group_values(
    compiled, name: str, group_values: dict, base: Optional[np.ndarray] = None
) -> np.ndarray:
    """Build a ``[B, n_neurons]`` override for per-neuron column ``name``.

    ``group_values`` maps group name -> ``[B]`` (one value per sample,
    broadcast over the group) or ``[B, group_size]`` arrays. Neurons of
    unlisted groups keep the compiled value (or ``base`` if given).
    """
    ref = base if base is not None else getattr(compiled, name)
    ref = np.asarray(ref, dtype=np.float64)
    B = None
    for values in group_values.values():
        b = np.asarray(values).shape[0]
        if B is None:
            B = b
        elif B != b:
            raise ValueError("inconsistent sample counts across groups")
    if B is None:
        raise ValueError("group_values is empty")
    out = np.broadcast_to(ref, (B,) + ref.shape).copy()
    for group, values in group_values.items():
        slots = np.asarray(compiled.groups[group])
        values = np.asarray(values, dtype=np.float64)
        if values.ndim == 1:
            out[:, slots] = values[:, None]
        else:
            if values.shape[1] != len(slots):
                raise ValueError(
                    f"override for group {group!r} has {values.shape[1]} "
                    f"columns, group has {len(slots)} neurons"
                )
            out[:, slots] = values
    return out


class ParameterSweep:
    """Simulate B parameter samples of one mapped chip simultaneously, on
    the chip's device.

    ``overrides`` maps device-array names (the per-neuron parameter and
    cost columns of ``ops/step.py:make_device_program``, e.g.
    ``threshold``, ``leak_decay``, ``bias``, ``soma_energy_update``, the
    block ``block_weights`` / ``block_counts``, or a conv filter
    ``conv_kernel_0``) to arrays of shape ``[B, *original.shape]`` in
    sanafe_tpu's layout.

    Note ``conv_kernel_i`` is the HWIO filter with an appended all-ones
    output channel (the destination arrival counter driving buffer_valid);
    when sweeping filter weights, scale ``kernel[..., :-1]`` and leave the
    last output channel at 1.
    """

    def __init__(self, chip, overrides: dict, dtype=None, mesh=None,
                 mesh_axis: str = None):
        """``dtype`` defaults to the chip's. ``mesh``, a one-dimensional
        ``DeviceMesh`` (anything else raises ``TypeError``), splits the
        samples over its ranks (module docstring); the sample count must
        divide its size. ``mesh_axis`` names its dimension (default: its
        only one). On the card the sweep's step scan replays CUDA graphs
        (``self.graphs``, ``ops/scan.py:ScanGraphs``), also on a mesh (a
        sweep's step has no collective); it runs eagerly where
        ``SANAFE_TPU_GRAPH=0`` is set when the sweep is built."""
        if mesh is not None:
            from .parallel import check_mesh

            check_mesh(mesh)
            if mesh_axis not in (None, *(mesh.mesh_dim_names or ())):
                raise ValueError(f"mesh has no dimension {mesh_axis!r}")
        c = chip.compiled
        if c is None:
            raise RuntimeError("No network loaded; call load() first")
        if c.has_poisson or (
            c.tn_noise_slots is not None and len(c.tn_noise_slots)
        ):
            raise ValueError(
                "ParameterSweep does not support host-fed stochastic models "
                "(Poisson inputs / TrueNorth LFSR noise); their RNG stream "
                "draw order is defined per-chip. Sweep deterministic "
                "configurations, then sim() the winner."
            )
        self.compiled = c
        self.device = chip.device
        # run() calls begun: the call id of their spans (tracing.py)
        self.runs = 0
        with tracing.span("sanafe.setup.sweep") as built:
            self._build(chip, overrides, dtype, mesh)
            built.fields["neuron.path"] = (
                "kernel" if self.prog.neuron is not None else "plain")

    def _build(self, chip, overrides: dict, dtype, mesh) -> None:
        """The sweep's program, its per-sample arrays and its graphs."""
        c = self.compiled
        # The fused roll-up / dense-delivery matvec bakes every cost column
        # and the edge weights into its coefficient matrix at build time;
        # overriding one of those arrays per sample would silently no-op.
        # Pure state-dynamics parameters stay runtime inputs, so fusion is
        # only disabled when a baked array is swept. Plugin soma parameters
        # (plugin_<model>_<param>) are runtime inputs of the plugin update
        # too; sanafe_tpu turns fusion off for them, which in float32 sums
        # the energies over the neurons in float32 instead of rounding the
        # fused float64 product once (1.1e-6 relative from a single chip's
        # on the 4096-neuron HH chip, PERF.md).
        fuse = all(name in DYNAMICS_ONLY or name.startswith("plugin_")
                   for name in overrides)
        # the batched kernel reads the live rows, never the cells; the
        # neuron phase stays PyTorch's (a [B, n] state)
        self.prog = make_device_program(
            c, chip.device, chip.dtype if dtype is None else dtype,
            fuse=fuse, hold_rows=True, batched=True)
        prog = self.prog
        if not overrides:
            raise ValueError("no overrides given; use SpikingChip.sim()")
        known = dict(prog.arrays)
        blocks = {}  # overrides of the blocks: sanafe_tpu's dense layout
        if prog.kernel_delivery:
            # the program holds the live rows alone; the blocks are swept
            # in sanafe_tpu's layout, counts included (the kernel reads
            # them packed), and compacted to the rows live in any sample
            dense = (prog.block.n_blocks, prog.block.tile, prog.block.tile)
            blocks = {"block_weights": (dense, prog.dtype),
                      "block_counts": (dense, torch.int8)}
            known.update(dict.fromkeys(blocks))
        B = None
        self.arrays = dict(prog.arrays)
        swept = {}  # name -> ([B, ...] values, dtype)
        for name, values in overrides.items():
            if name not in known:
                names = ", ".join(sorted(known))
                raise KeyError(
                    f"unknown device array {name!r}; valid names: {names}"
                )
            values = np.asarray(values)
            if not values.flags.writeable:  # e.g. np.broadcast_to's view
                values = values.copy()
            values = torch.as_tensor(values)
            if name in blocks:
                orig_shape, dtype_of = blocks[name]
            else:
                orig = prog.arrays[name]
                orig_shape, dtype_of = tuple(orig.shape), orig.dtype
            if name.startswith("conv_kernel_") and values.dim() >= 4:
                values = hwio_to_oihw(values)
            if values.dim() < 1 or tuple(values.shape[1:]) != orig_shape:
                raise ValueError(
                    f"override {name!r} must have shape [B, "
                    f"{', '.join(map(str, orig_shape))}] in sanafe_tpu's "
                    f"layout; got {tuple(np.shape(overrides[name]))}"
                )
            if B is None:
                B = values.shape[0]
            elif values.shape[0] != B:
                raise ValueError("inconsistent sample counts across overrides")
            swept[name] = (values, dtype_of)
        self.batch = B
        self.mesh = mesh
        lo, hi = 0, B
        if mesh is not None:
            from .parallel import mesh_rank

            rank, world, _ = mesh_rank(mesh)
            if B % world:
                raise ValueError(
                    f"sample count {B} must divide the mesh axis "
                    f"{mesh.mesh_dim_names[0] if mesh.mesh_dim_names else 0!r}"
                    f" ({world} devices)")
            lo, hi = rank * B // world, (rank + 1) * B // world
        self.samples = (lo, hi)  # this rank's samples
        dense = {}
        for name, (values, dtype_of) in swept.items():
            if name in blocks:  # kept on the host until compacted
                dense[name] = values[lo:hi].to(dtype=dtype_of)
            else:
                self.arrays[name] = values[lo:hi].to(device=self.device,
                                                     dtype=dtype_of)
        if prog.kernel_delivery:
            # the kernel's operands, checked once for every step: the rows
            # with an edge in any sample (the program's own where no sample
            # overrides the blocks)
            self.arrays["block_batch_plan"] = prog.block.batch_plan(
                hi - lo, dense.get("block_weights"),
                dense.get("block_counts"))
        # the step scan's graphs, captured at the first run (prog.graph)
        self.graphs = ScanGraphs(prog, self.arrays) if prog.graph else None

    def run(self, timesteps: int, chunk: int = 4096) -> dict:
        """Run ``timesteps`` steps for every sample; returns ``[B]``-shaped
        aggregates mirroring ``SpikingChip.sim()``'s result keys.

        One ``ops/scan.py:run_scan`` a chunk (on the card its CUDA graphs,
        ``self.graphs``, captured at the first run): the stats are summed
        on the device and copied to the host once a chunk. A call is a
        ``sanafe.sweep.run`` span, its id ``self.runs`` (``tracing.py``)."""
        self.runs += 1
        lo, hi = self.samples
        with tracing.span("sanafe.sweep.run", owner=self, call=self.runs,
                          steps=timesteps, samples=hi - lo):
            return self._run(timesteps, chunk)

    def _run(self, timesteps: int, chunk: int) -> dict:
        lo, hi = self.samples
        prog = self.prog
        state = initial_state(self.compiled, prog.dtype, self.device,
                              batch=hi - lo)
        counters = np.zeros((hi - lo, 5), dtype=np.int64)
        energies = np.zeros((hi - lo, 6), dtype=np.float64)
        t = 1
        remaining = timesteps
        while remaining > 0:
            length = min(chunk, remaining)
            with tracing.span("sanafe.chunk", steps=length):
                state, out = run_scan(prog, state, t, length,
                                      graphs=self.graphs, arrays=self.arrays)
                with tracing.span("sanafe.sweep.readback"):
                    stats = out["stats"].to(torch.float64)  # [T, B, 11]
                    counters += torch.round(stats[:, :, :5]).to(
                        torch.int64).sum(dim=0).cpu().numpy()
                    energies += stats[:, :, 5:11].sum(dim=0).cpu().numpy()
            t += length
            remaining -= length
        if self.mesh is not None:
            counters, energies = self._gather(counters, energies)
        return {
            "timesteps_executed": timesteps,
            "spikes": counters[:, 0],
            "packets_sent": counters[:, 1],
            "neurons_updated": counters[:, 3],
            "neurons_fired": counters[:, 4],
            "energy": {
                "synapse": energies[:, 0],
                "dendrite": energies[:, 1],
                "soma": energies[:, 2],
                "network": energies[:, 3],
                "total": energies[:, 4],
            },
            "sim_time": energies[:, 5],
        }

    def _gather(self, counters: np.ndarray, energies: np.ndarray) -> tuple:
        """Every rank's samples' counters and energies, ``[B, ...]``: one
        ``all_reduce`` of int64 rows, the float64 energies as their bit
        patterns, this rank's samples in place and zeros elsewhere."""
        import torch.distributed as dist

        lo, hi = self.samples
        group = self.mesh.get_group()
        on = (self.device if dist.get_backend(group) == "nccl"
              else torch.device("cpu"))
        rows = np.zeros((self.batch, 11), dtype=np.int64)
        rows[lo:hi, :5] = counters
        rows[lo:hi, 5:] = energies.view(np.int64)
        buf = torch.from_numpy(rows).to(on)
        dist.all_reduce(buf, group=group)
        rows = buf.cpu().numpy()
        return rows[:, :5], np.ascontiguousarray(rows[:, 5:]).view(np.float64)
