"""Fugu backend: execute Fugu scaffolds on the sanafe_tpu_torch simulator.

A copy of ``sanafe_tpu/fugu.py``, the counterpart to the reference's
``sanafe/fugu.py`` (a Sandia Fugu ``Backend`` implementation): bricks become
neuron groups, graph edges become synapses, input bricks become spike
trains, and output/probed neurons get spike + potential logging. Requires
the ``fugu`` package. The backend simulates on ``device`` (default
``"cuda"``, never replaced by the CPU: pass ``device="cpu"`` without a
card).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

try:
    from fugu.backends import Backend as _FuguBackend

    HAVE_FUGU = True
except ImportError:  # pragma: no cover - depends on env
    _FuguBackend = object
    HAVE_FUGU = False

from ._examples import load_loihi
from .arch import load_arch
from .chip import SpikingChip
from .network import SpikingNetwork as Network

MAX_NEURONS_PER_CORE = 1024

# Fugu property names → our LIF attribute names
_PARAM_MAP = {
    "decay": "leak_decay",
    "reset_voltage": "reset",
    "voltage": "potential",
}
_KNOWN_ATTRS = {
    "threshold", "leak_decay", "reset", "potential", "bias",
    "reset_mode", "reverse_reset_mode", "reverse_threshold",
    "reverse_reset", "refractory_delay", "input_decay", "spikes",
}


class sanafe_Backend(_FuguBackend):
    """Fugu Backend running scaffolds on a simulated neuromorphic chip."""

    def __init__(self, arch_name: str | None = None, device="cuda"):
        if not HAVE_FUGU:
            raise ImportError("The Fugu bridge requires the 'fugu' package")
        self.arch_name = arch_name
        self.device = device
        self.net = None
        self.arch = None
        self.record = "all"
        self.recordInGraph = False
        self.debug_mode = False

    # --- scaffold → network -------------------------------------------------
    def _convert_props(self, fugu_props: dict) -> dict:
        renamed = {
            _PARAM_MAP.get(key, key): value
            for key, value in fugu_props.items()
        }
        return {
            key: value
            for key, value in renamed.items()
            if key in _KNOWN_ATTRS
        }

    def _build_network(self) -> None:
        self.net = Network()
        self.node_map = {}
        self.fugu_name_to_neuron_number = {}
        self.input_map = set()
        self.brick_groups = defaultdict(list)
        neurons_to_record = set()
        input_neurons = set()
        record_all = self.record == "all"

        # input spike trains + output probes from the circuit bricks
        for brick_id, props in self.fugu_circuit.nodes.data():
            if props.get("layer") == "input":
                for timestep, neurons in enumerate(props["brick"]):
                    for name in neurons:
                        node = self.fugu_graph.nodes[name]
                        node.setdefault("spike_times", []).append(
                            timestep + 1
                        )
                        input_neurons.add(name)
            elif props.get("layer") == "output" and "ports" in props:
                for port in props["ports"].values():
                    if "data" in port.channels:
                        neurons_to_record.update(
                            port.channels["data"].neurons
                        )

        for name, props in self.fugu_graph.nodes.data():
            brick_tag = props.get("brick", "Misc")
            self.brick_groups[brick_tag].append(name)
            self.fugu_name_to_neuron_number[name] = props.get(
                "neuron_number"
            )
            if record_all:
                neurons_to_record.add(name)

        self.group_neurons = {}
        for brick_tag, neuron_list in self.brick_groups.items():
            group_name = brick_tag
            if brick_tag in self.fugu_circuit.nodes:
                group_name = self.fugu_circuit.nodes[brick_tag].get(
                    "name", brick_tag
                )
            group = self.net.create_neuron_group(
                str(group_name), len(neuron_list)
            )
            # groups are keyed by display name in traces; keep the lookup
            # from group name back to the fugu node ids
            self.group_neurons[str(group_name)] = neuron_list
            for i, fugu_node_id in enumerate(neuron_list):
                props = self.fugu_graph.nodes[fugu_node_id]
                attrs = self._convert_props(props)
                if fugu_node_id in input_neurons:
                    self.input_map.add(fugu_node_id)
                    spike_times = props.get("spike_times", [])
                    horizon = max(spike_times, default=0)
                    train = [
                        (step + 1) in spike_times for step in range(horizon)
                    ]
                    attrs["spikes"] = train
                if attrs:
                    group[i].set_attributes(model_attributes=attrs)
                if fugu_node_id in neurons_to_record:
                    group[i].set_attributes(
                        log_spikes=True, log_potential=True
                    )
                self.node_map[fugu_node_id] = group[i]

        for n1, n2, props in self.fugu_graph.edges.data():
            if n1 in self.node_map and n2 in self.node_map:
                self.node_map[n1].connect_to_neuron(
                    self.node_map[n2],
                    {"weight": props.get("weight", 1.0)},
                )

    def _map_to_cores(self) -> None:
        cores = self.arch.cores()
        core_idx, used = 0, 0
        for fugu_node_id, neuron in self.node_map.items():
            if used >= MAX_NEURONS_PER_CORE:
                core_idx += 1
                used = 0
                assert core_idx < len(cores)
            if fugu_node_id in self.input_map:
                neuron.set_attributes(soma_hw_name="demo_inputs")
            neuron.map_to_core(cores[core_idx])
            used += 1

    # --- Fugu Backend interface ----------------------------------------------
    def compile(self, scaffold, compile_args={}):
        self.scaffold = scaffold
        self.fugu_circuit = scaffold.circuit
        self.fugu_graph = scaffold.graph
        self.record = compile_args.get("record", "all")
        self.recordInGraph = compile_args.get("recordInGraph", False)
        self._build_network()

    def run(self, n_steps, return_potentials=False, debug_mode=False):
        import pandas as pd

        self.debug_mode = debug_mode
        self.arch = (
            load_arch(self.arch_name) if self.arch_name else load_loihi()
        )
        self._map_to_cores()
        chip = SpikingChip(self.arch, device=self.device)
        chip.load(self.net)
        result = chip.sim(
            n_steps,
            spike_trace=True,
            potential_trace=return_potentials or None,
            heartbeat=0,
        )
        from .data import potentials_to_dataframe, spikes_to_dataframe

        spikes_df = spikes_to_dataframe(result)
        spikes_df["time"] = spikes_df["timestep"] - 1.0
        numbers = []
        for _, row in spikes_df.iterrows():
            brick = self.group_neurons[row["group"]]
            fugu_name = brick[row["neuron_offset"]]
            numbers.append(self.fugu_name_to_neuron_number[fugu_name])
        spikes_df["neuron_number"] = numbers
        spikes_df = spikes_df.drop(
            columns=["timestep", "group", "neuron_offset", "neuron_id"]
        )
        if not return_potentials:
            return spikes_df
        potentials_df = potentials_to_dataframe(result)
        return spikes_df, potentials_df

    def cleanup(self):
        self.net = None
        self.node_map = {}
        self.brick_groups = defaultdict(list)

    def reset(self):
        self._build_network()

    def set_properties(self, properties={}):
        for fugu_node_id, props in properties.items():
            if fugu_node_id in self.node_map:
                self.node_map[fugu_node_id].set_attributes(
                    model_attributes=self._convert_props(props)
                )

    def set_input_spikes(self):
        self._build_network()
