"""Trace outputs: the five hard-named traces + run summary.

Mirrors the reference's trace surface (``src/chip.cpp:1447-1764``,
``src/pytrace.hpp``): each trace can target nothing, a CSV file, or an
in-memory Python object. CSV column formats and float formatting follow the
C++ writers (default ostream ``%g`` for raw doubles, ``%e`` scientific for
perf values).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np


def fmt_g(value: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return f"{value:g}"


def fmt_e(value: float) -> str:
    """C++ std::scientific double formatting."""
    return f"{value:e}"


@dataclass
class NeuronAddress:
    """Picklable (group, offset) address (src/pymodule.cpp:1097-1117)."""

    group_name: str
    neuron_offset: int

    def __repr__(self) -> str:
        return f"{self.group_name}.{self.neuron_offset}"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, NeuronAddress)
            and self.group_name == other.group_name
            and self.neuron_offset == other.neuron_offset
        )

    def __hash__(self) -> int:
        return hash((self.group_name, self.neuron_offset))


class TraceSink:
    """One trace target: closed / file / in-memory
    (TraceMode, src/pytrace.hpp:30-35)."""

    def __init__(self, target: Any, default_path: Optional[Path] = None):
        self.in_memory = target is True
        self.stream = None
        self._owns_stream = False
        if target is None or target is False:
            pass
        elif target is True:
            pass
        elif isinstance(target, (str, Path)):
            self.stream = open(target, "w")
            self._owns_stream = True
        elif hasattr(target, "write"):
            self.stream = target
        elif default_path is not None:
            self.stream = open(default_path, "w")
            self._owns_stream = True
        else:
            raise TypeError(f"Invalid trace target: {target!r}")

    @property
    def enabled(self) -> bool:
        return self.in_memory or self.stream is not None

    def write(self, text: str) -> None:
        if self.stream is not None:
            self.stream.write(text)

    def write_bytes(self, data: bytes) -> None:
        """Write pre-encoded UTF-8 rows, bypassing the text layer's
        encode step when the underlying stream exposes a binary buffer
        (megabyte-scale spike blobs at DVS scale). Ordering with prior
        text writes (the CSV header) is kept by flushing the text layer
        first."""
        if self.stream is None:
            return
        buffer = getattr(self.stream, "buffer", None)
        if buffer is not None:
            self.stream.flush()
            buffer.write(data)
        else:
            self.stream.write(data.decode("utf-8"))

    def close(self) -> None:
        if self._owns_stream and self.stream is not None:
            self.stream.close()
            self.stream = None


# --- in-memory trace containers (shapes per SURVEY Appendix A /
# src/pytrace.hpp:121-364) ---


@dataclass
class SpikeTrace:
    """Per-timestep lists of fired NeuronAddress (src/pytrace.hpp:121-145)."""

    data: list[list[NeuronAddress]] = field(default_factory=list)

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


def spike_lists(addresses: np.ndarray, counts: np.ndarray,
                rows: np.ndarray) -> list[list]:
    """``native.spike_rows``'s ``(counts, rows)`` as one list a step of
    ``addresses[row]``, an object array (the shared objects themselves,
    not copies)."""
    flat = addresses[rows].tolist()
    lists, start = [], 0
    for end in np.cumsum(counts).tolist():
        lists.append(flat[start:end])
        start = end
    return lists


@dataclass
class PotentialTrace:
    """Per-timestep lists of floats, one per log_potential neuron
    (src/pytrace.hpp:165-184)."""

    data: list[list[float]] = field(default_factory=list)

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


@dataclass
class NeuronTrace:
    """trace_name -> per-timestep lists of floats (src/pytrace.hpp:205-227)."""

    data: dict[str, list[list[float]]] = field(default_factory=dict)

    def __getitem__(self, name):
        return self.data[name]

    def keys(self):
        return self.data.keys()


@dataclass
class PerfTrace:
    """column -> list of per-timestep values (src/pytrace.hpp:247-278)."""

    data: dict[str, list] = field(default_factory=dict)

    def __getitem__(self, name):
        return self.data[name]

    def keys(self):
        return self.data.keys()


@dataclass
class MessageTrace:
    """Per-timestep lists of message dicts sorted by mid
    (src/pytrace.hpp:321-364)."""

    data: list[list[dict]] = field(default_factory=list)

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


PERF_COLUMNS = (
    "timestep",
    "fired",
    "updated",
    "packets",
    "hops",
    "spikes",
    "sim_time",
    "synapse_energy",
    "dendrite_energy",
    "soma_energy",
    "network_energy",
    "total_energy",
)


def write_spike_header(sink: TraceSink) -> None:
    sink.write("neuron,timestep\n")


def write_potential_header(sink: TraceSink, labels) -> None:
    parts = ["timestep"]
    for group_name, offset in labels:
        parts.append(f"neuron {group_name}.{offset}")
    sink.write(",".join(parts) + ",\n")


def write_perf_header(sink: TraceSink, optional_columns=()) -> None:
    columns = list(PERF_COLUMNS) + list(optional_columns)
    sink.write(",".join(columns) + "\n")


def write_neuron_trace_header(sink: TraceSink, labels, trace_names) -> None:
    parts = ["timestep"]
    for group_name, offset in labels:
        for trace_name in trace_names:
            parts.append(f"neuron {group_name}.{offset}/{trace_name}")
    sink.write(",".join(parts) + ",\n")


def write_message_header(sink: TraceSink) -> None:
    sink.write(
        "timestep,mid,src_neuron,src_hw,dest_hw,hops,spikes,"
        "send_timestamp,received_timestamp,processed_timestamp,"
        "generation_delay,processing_delay,network_delay,blocking_delay,"
        "min_hop_delay,messages_along_route\n"
    )


def message_to_dict(m) -> dict:
    """Message → dict (src/pytrace.hpp:25-27, message_to_dict)."""
    return {
        "timestep": m.timestep,
        "mid": m.mid,
        "src_neuron": f"{m.src_neuron_group}.{m.src_neuron_offset}",
        "src_hw": f"{m.src_tile_id}.{m.src_core_offset}",
        "dest_hw": (
            "x.x" if m.placeholder else f"{m.dest_tile_id}.{m.dest_core_offset}"
        ),
        "hops": m.hops,
        "spikes": m.spikes,
        "generation_delay": m.generation_delay,
        "processing_delay": m.processing_delay,
        "network_delay": m.network_delay,
        "blocking_delay": m.blocking_delay,
        "min_hop_delay": m.min_hop_delay,
        "sent_timestamp": m.sent_timestamp,
        "received_timestamp": m.received_timestamp,
        "processed_timestamp": m.processed_timestamp,
        "messages_along_route": m.messages_along_route,
    }


def write_message_row(sink: TraceSink, m) -> None:
    dest = "x.x" if m.placeholder else f"{m.dest_tile_id}.{m.dest_core_offset}"
    sink.write(
        f"{m.timestep},{m.mid},"
        f"{m.src_neuron_group}.{m.src_neuron_offset},"
        f"{m.src_tile_id}.{m.src_core_offset},{dest},"
        f"{m.hops},{m.spikes},"
        f"{fmt_g(m.sent_timestamp)},{fmt_g(m.received_timestamp)},"
        f"{fmt_g(m.processed_timestamp)},"
        f"{fmt_g(m.generation_delay)},{fmt_g(m.processing_delay)},"
        f"{fmt_g(m.network_delay)},{fmt_g(m.blocking_delay)},"
        f"{fmt_g(m.min_hop_delay)},{fmt_g(m.messages_along_route)}\n"
    )
