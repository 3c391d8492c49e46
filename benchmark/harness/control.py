"""The reference put in the program's place: the cell's calls served by
the plain reference at a lower precision than the configuration states
(the control, which ``correct`` has to refuse), or at the configuration's
own precision with a planted fault. ``runner.run_cell(..., calls=...)``
drives a run through these instead of the program. The reference is the
module that the cell's configuration names (``Cell.reference``)."""

from collections import namedtuple

import numpy as np
import torch

from ..reference import noc
from .judge import COUNTERS, ENERGIES
from .runner import SimCalls, SweepCalls

Address = namedtuple("Address", "group_name neuron_offset")
Trace = namedtuple("Trace", "data")

FAULTS = ("stale_state", "half_batch", "altered_answer")
# faults in what one sim call hands the next: every call restarts from the
# loaded chip's state, or hands on its state from the end of its last full
# block of GRAPH_UNROLL steps instead of its last step
CARRY_FAULTS = ("restart_state", "last_block_state")
GRAPH_UNROLL = 16


def result_of(totals: dict) -> dict:
    """One chip's totals as ``SpikingChip.sim`` returns them."""
    out = {key: int(totals[key][0]) for key in COUNTERS}
    out["energy"] = {key: float(totals["energy"][key][0]) for key in ENERGIES}
    out["sim_time"] = float(totals["sim_time"][0])
    return out


def add_totals(a: dict, b: dict) -> dict:
    """The totals of two runs back to back."""
    out = {key: a[key] + b[key] for key in COUNTERS}
    out["energy"] = {key: a["energy"][key] + b["energy"][key]
                     for key in ENERGIES}
    out["sim_time"] = a["sim_time"] + b["sim_time"]
    return out


class ControlSim(SimCalls):
    """``sim`` calls served by the reference in ``dtype`` (TF32 allowed
    where ``allow_tf32``), its state carried from call to call, with
    ``fault`` (one of ``FAULTS`` or ``CARRY_FAULTS``) planted where
    given."""

    def __init__(self, desc: dict, traffic: dict, device, reference, dtype,
                 allow_tf32: bool = False, fault: str = None):
        super().__init__(None, traffic, reference)
        self.layout = reference.Layout(desc)
        self.fault = fault
        self.ref = reference.Reference(
            self.layout, device, dtype, allow_tf32=allow_tf32,
            fault=fault if fault in ("stale_state", "half_batch") else None)
        # the host sweep is float64 in the program: its control reads its
        # latencies in float32, the nearest precision below
        rounding = np.float64 if dtype == torch.float64 else np.float32
        self.tabs = (noc.tables(self.layout, rounding) if self.detailed
                     else None)
        self.state = None
        self.t = 1

    def call(self):
        state = self.state
        if state is None:
            state = self.ref.initial_state()
        planes_wanted = self.detailed or self.spike_trace
        block = self.steps // GRAPH_UNROLL * GRAPH_UNROLL
        if self.fault == "last_block_state" and 0 < block < self.steps:
            state, totals, planes = self.ref.run(
                state, self.t, block, raster=planes_wanted)
            handed = state
            _, rest, more = self.ref.run(state, self.t + block,
                                         self.steps - block,
                                         raster=planes_wanted)
            totals = add_totals(totals, rest)
            if planes_wanted:
                planes = tuple(torch.cat(pair) for pair in zip(planes, more))
        else:
            handed, totals, planes = self.ref.run(
                state, self.t, self.steps, raster=planes_wanted)
        self.state = None if self.fault == "restart_state" else handed
        self.t += self.steps
        result = result_of(totals)
        if planes_wanted:
            fired = planes[0][:, 0].cpu().numpy()
            updated = planes[1][:, 0].cpu().numpy()
        if self.detailed:
            acc = 0.0
            with noc.Sweeper(self.tabs, self.sweep_workers) as sweeper:
                for v in sweeper.times(fired, updated).tolist():
                    acc += v
            result["sim_time"] = acc
        if self.spike_trace:
            names = [(g, lo) for g, (lo, _) in self.layout.groups.items()]
            data = []
            for step in fired:
                data.append([Address(*self.address(names, int(i)))
                             for i in np.flatnonzero(step)])
            result["spike_trace"] = Trace(data)
        if self.fault == "altered_answer":
            result["neurons_fired"] += 1
        return result

    @staticmethod
    def address(names, i: int) -> tuple:
        for g, lo in reversed(names):
            if i >= lo:
                return g, i - lo
        raise IndexError(i)

    def snapshot(self):
        if self.state is None:
            return None
        return {key: self.state[key][0].clone()
                for key in self.reference.STATE_KEYS}

    def t0(self) -> int:
        return self.t

    def walls(self) -> dict:
        return {"neuron_processing": 0.0, "message_processing": 0.0,
                "energy_stats": 0.0, "scheduler": 0.0, "graph_replays": 0}

    def release(self, layout) -> None:
        self.order = torch.arange(layout.n)
        self.ref = None
        self.state = None


class ControlSweep(SweepCalls):
    """Sweep runs served by the reference in ``dtype``, with ``fault``
    planted where given."""

    def __init__(self, desc: dict, traffic: dict, device, reference, dtype,
                 allow_tf32: bool = False, fault: str = None):
        super().__init__(None, None, traffic, desc, reference)
        layout = reference.Layout(desc)
        base = layout.params[self.parameter]
        self.fault = fault
        self.ref = reference.Reference(
            layout, device, dtype, allow_tf32=allow_tf32,
            fault=None if fault == "altered_answer" else fault,
            overrides={self.parameter: self.scales[:, None] * base[None, :]})

    def call(self):
        _, totals, _ = self.ref.run(self.ref.initial_state(self.samples), 1,
                                    self.steps)
        out = {key: totals[key].copy() for key in COUNTERS}
        out["energy"] = {key: totals["energy"][key].copy()
                         for key in ENERGIES}
        out["sim_time"] = totals["sim_time"].copy()
        if self.fault == "altered_answer":
            out["neurons_fired"][0] += 1
        return out

    def release(self, layout) -> None:
        self.ref = None


def factory(dtype=torch.float32, allow_tf32: bool = False,
            fault: str = None):
    """A ``calls`` factory for ``runner.run_cell``: the control or a
    planted fault in the program's place."""

    def make(desc: dict, traffic: dict, device, reference):
        cls = ControlSim if traffic["entry"] == "sim" else ControlSweep
        return cls(desc, traffic, device, reference, dtype, allow_tf32,
                   fault)

    return make
