"""Spiking-network graph (host side, unmapped SNN).

Mirrors the reference's ``SpikingNetwork`` / ``NeuronGroup`` / ``Neuron`` /
``Connection`` hierarchy (``src/network.hpp``, ``src/network.cpp``):
string-keyed attribute maps, group-level hyperedge generators (dense / sparse /
conv2d), and neuron→core mapping that stamps a global ``mapping_order``.

Lowering formulas are parity-critical and mirror the reference exactly:

- conv2d: zero padding; ``out_w = (in_w - k_w) / s_w + 1``; neuron indexing is
  channels-first flattened; filter attribute lists are flattened
  ``[y][x][c_in][c_out]`` (``src/network.cpp:377-528``).
- dense: attribute lists index as ``src_index * n_dest + dest_index``
  (``src/network.cpp:567-605``).
- sparse: attribute lists index by *edge position* in ``source_target_pairs``
  and every list length must equal the pair count (``src/network.cpp:229-276``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from .arch import Architecture, CoreAddress, CoreConfiguration
from .attributes import Attribute, is_reserved_neuron_attribute


@dataclass
class NeuronConfiguration:
    """Neuron attribute template (src/network.hpp:30-38)."""

    model_attributes: dict[str, Attribute] = field(default_factory=dict)
    soma_hw_name: Optional[str] = None
    default_synapse_hw_name: Optional[str] = None
    dendrite_hw_name: Optional[str] = None
    log_spikes: Optional[bool] = None
    log_potential: Optional[bool] = None

    def copy(self) -> "NeuronConfiguration":
        return NeuronConfiguration(
            model_attributes=dict(self.model_attributes),
            soma_hw_name=self.soma_hw_name,
            default_synapse_hw_name=self.default_synapse_hw_name,
            dendrite_hw_name=self.dendrite_hw_name,
            log_spikes=self.log_spikes,
            log_potential=self.log_potential,
        )


@dataclass
class NeuronAddress:
    group_name: str
    neuron_offset: Optional[int] = None

    def info(self) -> str:
        if self.neuron_offset is None:
            return self.group_name
        return f"{self.group_name}.{self.neuron_offset}"


@dataclass
class Conv2DParameters:
    input_width: int = 0
    input_height: int = 0
    input_channels: int = 0
    kernel_width: int = 0
    kernel_height: int = 0
    kernel_count: int = 1
    stride_width: int = 1
    stride_height: int = 1


class Connection:
    """A single synaptic edge (src/network.hpp:180-194)."""

    __slots__ = (
        "synapse_attributes",
        "dendrite_attributes",
        "synapse_hw_name",
        "pre_neuron",
        "post_neuron",
        "id",
    )

    def __init__(self, edge_id: int):
        self.id = edge_id
        self.synapse_attributes: dict[str, Attribute] = {}
        self.dendrite_attributes: dict[str, Attribute] = {}
        self.synapse_hw_name: str = ""
        self.pre_neuron = NeuronAddress("")
        self.post_neuron = NeuronAddress("")

    def info(self) -> str:
        return (
            f"sanafe::Connection(pre_neuron={self.pre_neuron.info()} "
            f"post_neuron={self.post_neuron.info()})"
        )


class Neuron:
    __slots__ = (
        "edges_out",
        "model_attributes",
        "soma_hw_name",
        "default_synapse_hw_name",
        "dendrite_hw_name",
        "parent_group_name",
        "parent_net",
        "offset",
        "core_address",
        "mapping_order",
        "log_spikes",
        "log_potential",
    )

    def __init__(
        self,
        neuron_offset: int,
        net: "SpikingNetwork",
        parent_group_name: str,
        config: NeuronConfiguration,
    ):
        self.edges_out: list[Connection] = []
        self.model_attributes: dict[str, Attribute] = {}
        self.soma_hw_name = ""
        self.default_synapse_hw_name = ""
        self.dendrite_hw_name = ""
        self.parent_group_name = parent_group_name
        self.parent_net = net
        self.offset = neuron_offset
        self.core_address: Optional[CoreAddress] = None
        self.mapping_order = 0
        self.log_spikes = False
        self.log_potential = False
        self.set_attributes(config)

    def get_id(self) -> int:
        return self.offset

    def set_attributes(
        self,
        config: NeuronConfiguration | None = None,
        *,
        model_attributes: dict | None = None,
        soma_hw_name: str | None = None,
        default_synapse_hw_name: str | None = None,
        synapse_hw_name: str | None = None,
        dendrite_hw_name: str | None = None,
        log_spikes: bool | None = None,
        log_potential: bool | None = None,
    ) -> None:
        """Apply a configuration template (src/network.cpp:94-128). Accepts
        either a NeuronConfiguration or the reference Python module's
        keyword style (plain-value attribute dicts)."""
        if config is None:
            config = NeuronConfiguration(
                model_attributes=_wrap_attribute_dict(model_attributes or {}),
                soma_hw_name=soma_hw_name,
                default_synapse_hw_name=(
                    default_synapse_hw_name
                    if default_synapse_hw_name is not None
                    else synapse_hw_name
                ),
                dendrite_hw_name=dendrite_hw_name,
                log_spikes=log_spikes,
                log_potential=log_potential,
            )
        if config.default_synapse_hw_name is not None:
            self.default_synapse_hw_name = config.default_synapse_hw_name
        if config.dendrite_hw_name is not None:
            self.dendrite_hw_name = config.dendrite_hw_name
        if config.soma_hw_name is not None:
            self.soma_hw_name = config.soma_hw_name
        if config.log_spikes is not None:
            self.log_spikes = config.log_spikes
        if config.log_potential is not None:
            self.log_potential = config.log_potential
        for key, attribute in config.model_attributes.items():
            if is_reserved_neuron_attribute(key):
                raise ValueError(
                    f"Reserved neuron attribute {key!r} cannot be used as a "
                    "model attribute. Pass it as a direct argument instead."
                )
            self.model_attributes[key] = attribute

    def connect_to_neuron(
        self, dest: "Neuron", attributes: dict | None = None
    ) -> int:
        """Create an outgoing edge to ``dest`` (src/network.cpp:175-192).
        Optional ``attributes`` (plain values or Attribute objects) forward
        to both the synapse and dendrite scopes."""
        edge = Connection(len(self.edges_out))
        edge.pre_neuron = NeuronAddress(self.parent_group_name, self.offset)
        edge.post_neuron = NeuronAddress(dest.parent_group_name, dest.offset)
        edge.synapse_hw_name = dest.default_synapse_hw_name
        if attributes:
            wrapped = _wrap_attribute_dict(attributes)
            edge.synapse_attributes.update(wrapped)
            edge.dendrite_attributes.update(wrapped)
        self.edges_out.append(edge)
        return edge.id

    def map_to_core(self, core: CoreConfiguration) -> None:
        """Stamp mapping order; actual hardware binding happens at chip
        load time (src/network.cpp:85-92)."""
        self.core_address = core.address
        self.mapping_order = self.parent_net.update_mapping_count()

    def info(self) -> str:
        return (
            f"sanafe::Neuron(nid={self.parent_group_name}.{self.offset} "
            f"edges_out={len(self.edges_out)})"
        )


@dataclass
class BulkEdges:
    """A group-level hyperedge lowered to flat numpy arrays instead of
    per-edge ``Connection`` objects — the fast path for conv2d, dense and
    sparse generators at scale (a DVS-gesture net has 3.5M edges, TCAD'25's
    largest random net 16.8M; building Python objects for each dominates
    load time). Attribute arrays are keyed by
    name with (values, forward_to_synapse, forward_to_dendrite) tuples."""

    dest_group_name: str
    src_idx: "np.ndarray"  # [E] int32 offsets into the source group
    dest_idx: "np.ndarray"  # [E] int32 offsets into the dest group
    attributes: dict[str, tuple["np.ndarray", bool, bool]] = field(
        default_factory=dict
    )
    # Generator structure, when the hyperedge came from a structured
    # generator: ("conv2d", Conv2DParameters, filter_weights_f64 | None).
    # Lets the device program deliver spikes as an actual convolution
    # (ops/step.py build_conv_delivery) instead of materialized edges.
    structure: "Optional[tuple]" = None

    def __len__(self) -> int:
        return len(self.src_idx)


# Hyperedge calls below this many edges build per-edge Connection objects
# (keeping the reference's introspectable edges_out API); at or above it
# they lower straight to BulkEdges arrays.
BULK_EDGE_THRESHOLD = 16384


def _wrap_attribute_dict(values: dict) -> dict[str, Attribute]:
    """Wrap plain Python/numpy values into Attributes (pass-through for
    Attribute instances); mirrors pydict_to_model_attributes
    (src/pymodule.cpp:64-89)."""
    out: dict[str, Attribute] = {}
    for key, value in values.items():
        if isinstance(value, Attribute):
            out[key] = value
        elif isinstance(value, np.ndarray):
            out[key] = Attribute(value.tolist(), name=key)
        elif isinstance(value, np.generic):
            out[key] = Attribute(value.item(), name=key)
        else:
            out[key] = Attribute(value, name=key)
    return out


def _normalize_attribute_lists(
    attribute_lists: dict,
) -> dict[str, list[Attribute]]:
    """Normalize hyperedge per-edge attribute lists: plain scalars, numpy
    arrays, and Attribute objects are all accepted."""
    out: dict[str, list[Attribute]] = {}
    for key, values in attribute_lists.items():
        if isinstance(values, np.ndarray):
            values = values.tolist()
        normalized = []
        for value in values:
            if isinstance(value, Attribute):
                normalized.append(value)
            elif isinstance(value, np.generic):
                normalized.append(Attribute(value.item(), name=key))
            else:
                normalized.append(Attribute(value, name=key))
        out[key] = normalized
    return out


_PLAIN_NUMBERS = (int, float, np.integer, np.floating)


def _edge_value_arrays(
    attribute_lists: dict,
) -> Optional[dict[str, tuple["np.ndarray", bool, bool]]]:
    """Per-edge values as float64 arrays, without an ``Attribute`` per
    value: a one-dimensional numeric numpy array, a list of plain numbers,
    or a list of ``Attribute``s of plain numbers that all forward alike.
    None where any value needs the object path (a bool, a string, a list,
    mixed forwarding)."""
    arrays: dict[str, tuple[np.ndarray, bool, bool]] = {}
    for key, values in attribute_lists.items():
        if isinstance(values, np.ndarray):
            if values.dtype.kind not in "iuf" or values.ndim != 1:
                return None
            arrays[key] = (values.astype(np.float64), True, True)
            continue
        types = set(map(type, values))
        if types and all(issubclass(t, _PLAIN_NUMBERS)
                         and not issubclass(t, (bool, np.bool_))
                         for t in types):
            arrays[key] = (np.asarray(values, dtype=np.float64), True, True)
        elif types == {Attribute}:
            flags = {(a.forward_to_synapse, a.forward_to_dendrite)
                     for a in values}
            plain = [a.value for a in values]
            kinds = set(map(type, plain))
            if len(flags) != 1 or not all(
                issubclass(t, _PLAIN_NUMBERS)
                and not issubclass(t, (bool, np.bool_)) for t in kinds
            ):
                return None
            fwd_syn, fwd_den = flags.pop()
            arrays[key] = (np.asarray(plain, dtype=np.float64), fwd_syn,
                           fwd_den)
        else:
            return None
    return arrays


def _pair_arrays(pairs) -> Optional[tuple["np.ndarray", "np.ndarray"]]:
    """(source ids, dest ids) int64 of ``pairs``, an ``[E, 2]`` integer
    array or a list or tuple of integer (source, dest) pairs; None for
    anything else."""
    if isinstance(pairs, np.ndarray):
        if pairs.dtype.kind not in "iu" or pairs.ndim != 2 or (
            pairs.shape[1] != 2
        ):
            return None
        ids = pairs.astype(np.int64)
        return ids[:, 0], ids[:, 1]
    if not isinstance(pairs, (list, tuple)) or set(map(len, pairs)) != {2}:
        return None
    first = pairs[0]
    if not all(isinstance(v, (int, np.integer))
               and not isinstance(v, (bool, np.bool_)) for v in first):
        return None
    try:
        flat = np.fromiter(itertools.chain.from_iterable(pairs),
                           dtype=np.int64, count=2 * len(pairs))
    except (TypeError, ValueError, OverflowError):
        return None
    return flat[0::2], flat[1::2]


class NeuronGroup:
    def __init__(
        self,
        group_name: str,
        net: "SpikingNetwork",
        neuron_count: int,
        default_config: NeuronConfiguration | None = None,
    ):
        self.name = group_name
        self.default_neuron_config = default_config or NeuronConfiguration()
        self.bulk_edges: list[BulkEdges] = []
        self.neurons = [
            Neuron(offset, net, group_name, self.default_neuron_config)
            for offset in range(neuron_count)
        ]

    def get_name(self) -> str:
        return self.name

    def __len__(self) -> int:
        return len(self.neurons)

    def __getitem__(self, offset: int) -> Neuron:
        return self.neurons[offset]

    def __iter__(self):
        return iter(self.neurons)

    def info(self) -> str:
        return f"sanafe::NeuronGroup(gid={self.name} neurons={len(self.neurons)})"

    # --- hyperedge generators ---
    def connect_neurons_dense(
        self,
        dest_group: "NeuronGroup",
        attribute_lists: dict[str, list[Attribute]],
    ) -> None:
        """All-to-all connect; lists index src*n_dest+dest
        (src/network.cpp:567-605)."""
        n_dest = len(dest_group.neurons)
        n_src = len(self.neurons)
        arrays = (
            _edge_value_arrays(attribute_lists)
            if n_src * n_dest >= BULK_EDGE_THRESHOLD
            else None
        )
        if arrays is not None:
            src_idx = np.repeat(
                np.arange(n_src, dtype=np.int32), n_dest
            )
            dest_idx = np.tile(np.arange(n_dest, dtype=np.int32), n_src)
            list_idx = src_idx.astype(np.int64) * n_dest + dest_idx
            edge_attrs = {}
            for key, (values, fwd_syn, fwd_den) in arrays.items():
                if len(values) < n_src * n_dest:
                    raise ValueError(
                        f"Not enough entries defined for attribute "
                        f"({len(values)}): {key}"
                    )
                edge_attrs[key] = (values[list_idx], fwd_syn, fwd_den)
            self.bulk_edges.append(
                BulkEdges(
                    dest_group_name=dest_group.name,
                    src_idx=src_idx,
                    dest_idx=dest_idx,
                    attributes=edge_attrs,
                )
            )
            return
        attribute_lists = _normalize_attribute_lists(attribute_lists)
        for source_index, source in enumerate(self.neurons):
            for dest_index, dest in enumerate(dest_group.neurons):
                list_index = source_index * n_dest + dest_index
                con = source.edges_out[source.connect_to_neuron(dest)]
                _apply_edge_attribute_lists(con, attribute_lists, list_index)

    def connect_neurons_sparse(
        self,
        dest_group: "NeuronGroup",
        attribute_lists: dict[str, list[Attribute]],
        source_dest_id_pairs: list[tuple[int, int]],
    ) -> None:
        """Pairwise connect; lists index by edge position and must match the
        pair count exactly (src/network.cpp:229-276). At or above
        ``BULK_EDGE_THRESHOLD`` pairs with plain numeric values the
        hyperedge lowers to ``BulkEdges`` arrays (``_sparse_bulk_edges``)."""
        n_pairs = len(source_dest_id_pairs)
        for key, value_list in attribute_lists.items():
            if len(value_list) != n_pairs:
                raise ValueError(
                    "Length of attribute list != number of defined edges. "
                    f"({len(value_list)}!={n_pairs})"
                )
        if n_pairs >= BULK_EDGE_THRESHOLD:
            bulk = self._sparse_bulk_edges(
                dest_group, attribute_lists, source_dest_id_pairs)
            if bulk is not None:
                self.bulk_edges.append(bulk)
                return
        attribute_lists = _normalize_attribute_lists(attribute_lists)
        for edge_idx, (source_id, dest_id) in enumerate(source_dest_id_pairs):
            if source_id >= len(self.neurons):
                raise ValueError(f"src id is out of range: {source_id}")
            if dest_id >= len(dest_group.neurons):
                raise ValueError(f"dest nid is out of range: {dest_id}")
            source = self.neurons[source_id]
            dest = dest_group.neurons[dest_id]
            con = source.edges_out[source.connect_to_neuron(dest)]
            # Sparse forwards each listed attribute to both synapse and
            # dendrite maps, keeping original forwarding flags
            # (src/network.cpp:256-273).
            attributes = {k: v[edge_idx] for k, v in attribute_lists.items()}
            con.synapse_attributes = dict(attributes)
            con.dendrite_attributes = dict(attributes)

    def _sparse_bulk_edges(
        self,
        dest_group: "NeuronGroup",
        attribute_lists: dict,
        pairs,
    ) -> Optional[BulkEdges]:
        """The sparse hyperedge as ``BulkEdges``: the pairs and each
        attribute's values as arrays, with no object per edge. None where
        the object path must take it: a value that is not a plain number,
        pairs that are not integer (source, dest) pairs, or attributes that
        compile reads differently from arrays (``compartment``; both
        spellings of the weight or of the delay). Ids are checked as the
        object path checks them, the first bad pair in edge order
        raising the same error."""
        keys = set(attribute_lists)
        if "compartment" in keys or {"w", "weight"} <= keys or (
            {"delay", "d"} <= keys
        ):
            return None
        arrays = _edge_value_arrays(attribute_lists)
        if arrays is None:
            return None
        ids = _pair_arrays(pairs)
        if ids is None:
            return None
        src, dst = ids
        n_src, n_dest = len(self.neurons), len(dest_group.neurons)
        # a negative id counts from the end, as a list index does
        src = np.where(src < 0, src + n_src, src)
        dst = np.where(dst < 0, dst + n_dest, dst)
        bad = np.flatnonzero((src >= n_src) | (dst >= n_dest)
                             | (src < 0) | (dst < 0))
        if bad.size:
            k = bad[0]
            if src[k] >= n_src:
                raise ValueError(f"src id is out of range: {pairs[k][0]}")
            if src[k] < 0:
                raise IndexError("list index out of range")
            if dst[k] >= n_dest:
                raise ValueError(f"dest nid is out of range: {pairs[k][1]}")
            raise IndexError("list index out of range")
        return BulkEdges(
            dest_group_name=dest_group.name,
            src_idx=src.astype(np.int32),
            dest_idx=dst.astype(np.int32),
            attributes=arrays,
        )

    def connect_neurons_conv2d(
        self,
        dest_group: "NeuronGroup",
        attribute_lists: dict,
        convolution: "Conv2DParameters | int" = None,
        input_height: int = 0,
        input_channels: int = 0,
        kernel_width: int = 0,
        kernel_height: int = 0,
        kernel_count: int = 1,
        stride_width: int = 1,
        stride_height: int = 1,
    ) -> None:
        """Lower a 2D convolution to individual edges
        (src/network.cpp:278-528). Accepts either a Conv2DParameters or the
        reference Python module's positional ints
        (src/pymodule.cpp:335-356)."""
        if isinstance(convolution, Conv2DParameters):
            c = convolution
        else:
            c = Conv2DParameters(
                input_width=int(convolution),
                input_height=input_height,
                input_channels=input_channels,
                kernel_width=kernel_width,
                kernel_height=kernel_height,
                kernel_count=kernel_count,
                stride_width=stride_width,
                stride_height=stride_height,
            )
        for name, value in (
            ("input_width", c.input_width),
            ("input_height", c.input_height),
            ("input_channels", c.input_channels),
            ("kernel_width", c.kernel_width),
            ("kernel_height", c.kernel_height),
            ("kernel_count", c.kernel_count),
            ("stride_width", c.stride_width),
            ("stride_height", c.stride_height),
        ):
            if value <= 0:
                raise ValueError(
                    f"Conv2D parameter {name!r} must be > 0 (got {value})"
                )
        if c.kernel_width > c.input_width or c.kernel_height > c.input_height:
            raise ValueError(
                f"Conv2D kernel ({c.kernel_width}x{c.kernel_height}) larger "
                f"than input ({c.input_width}x{c.input_height}) with zero "
                "padding."
            )

        out_w = (c.input_width - c.kernel_width) // c.stride_width + 1
        out_h = (c.input_height - c.kernel_height) // c.stride_height + 1
        out_c = c.kernel_count
        expected_input = c.input_channels * c.input_width * c.input_height
        expected_output = out_c * out_w * out_h
        if expected_input != len(self.neurons):
            raise ValueError(
                f"Expected {expected_input} neurons in source group for "
                f"convolution but there are {len(self.neurons)} neurons."
            )
        if expected_output != len(dest_group.neurons):
            raise ValueError(
                f"Expected {expected_output} neurons in dest group for "
                f"convolution but there are {len(dest_group.neurons)} neurons."
            )

        n_conv_edges = (
            expected_output
            * c.input_channels
            * c.kernel_height
            * c.kernel_width
        )
        arrays = (
            _edge_value_arrays(attribute_lists)
            if n_conv_edges >= BULK_EDGE_THRESHOLD
            else None
        )
        if arrays is not None:
            # Vectorized lowering (identical index formulas, creation order
            # = (c_out, y_out, x_out, c_in, y_f, x_f) scan; Appendix-A
            # parity with src/network.cpp:377-528)
            co, yo, xo, ci, yf, xf = [
                g.ravel()
                for g in np.meshgrid(
                    np.arange(out_c),
                    np.arange(out_h),
                    np.arange(out_w),
                    np.arange(c.input_channels),
                    np.arange(c.kernel_height),
                    np.arange(c.kernel_width),
                    indexing="ij",
                )
            ]
            src_idx = (
                ci * c.input_width * c.input_height
                + (yo * c.stride_height + yf) * c.input_width
                + (xo * c.stride_width + xf)
            )
            dest_idx = co * out_w * out_h + yo * out_w + xo
            filter_idx = (
                yf * c.kernel_width * c.input_channels * c.kernel_count
                + xf * c.input_channels * c.kernel_count
                + ci * c.kernel_count
                + co
            )
            edge_attrs = {}
            for key, (values, fwd_syn, fwd_den) in arrays.items():
                if len(values) <= filter_idx.max(initial=0):
                    raise ValueError(
                        f"Not enough entries defined for attribute "
                        f"({len(values)}): {key}"
                    )
                edge_attrs[key] = (values[filter_idx], fwd_syn, fwd_den)
            filter_weights = None
            for key in ("w", "weight"):
                if key in arrays:
                    values, fwd_syn, _ = arrays[key]
                    if fwd_syn:
                        filter_weights = np.asarray(values, dtype=np.float64)
            self.bulk_edges.append(
                BulkEdges(
                    dest_group_name=dest_group.name,
                    src_idx=src_idx.astype(np.int32),
                    dest_idx=dest_idx.astype(np.int32),
                    attributes=edge_attrs,
                    structure=("conv2d", c, filter_weights),
                )
            )
            return

        attribute_lists = _normalize_attribute_lists(attribute_lists)
        for c_out in range(out_c):
            for y_out in range(out_h):
                for x_out in range(out_w):
                    dest_idx = c_out * out_w * out_h + y_out * out_w + x_out
                    dest = dest_group.neurons[dest_idx]
                    for c_in in range(c.input_channels):
                        for y_f in range(c.kernel_height):
                            y_pos = y_out * c.stride_height + y_f
                            if not (0 <= y_pos < c.input_height):
                                continue
                            for x_f in range(c.kernel_width):
                                x_pos = x_out * c.stride_width + x_f
                                if not (0 <= x_pos < c.input_width):
                                    continue
                                src_idx = (
                                    c_in * c.input_width * c.input_height
                                    + y_pos * c.input_width
                                    + x_pos
                                )
                                # Filter laid out [y][x][c_in][c_out]
                                filter_idx = (
                                    y_f
                                    * c.kernel_width
                                    * c.input_channels
                                    * c.kernel_count
                                    + x_f * c.input_channels * c.kernel_count
                                    + c_in * c.kernel_count
                                    + c_out
                                )
                                source = self.neurons[src_idx]
                                con = source.edges_out[
                                    source.connect_to_neuron(dest)
                                ]
                                _apply_edge_attribute_lists(
                                    con, attribute_lists, filter_idx
                                )


def _apply_edge_attribute_lists(
    con: Connection,
    attribute_lists: dict[str, list[Attribute]],
    index: int,
) -> None:
    """Pick entry ``index`` of each per-edge attribute list and forward it by
    scope (src/network.cpp:530-560)."""
    for key, attribute_list in attribute_lists.items():
        if len(attribute_list) <= index:
            raise ValueError(
                f"Not enough entries defined for attribute "
                f"({len(attribute_list)}): {key}"
            )
        attribute = attribute_list[index]
        if attribute.forward_to_synapse:
            con.synapse_attributes[key] = attribute
        if attribute.forward_to_dendrite:
            con.dendrite_attributes[key] = attribute


class SpikingNetwork:
    def __init__(self, name: str = ""):
        self.name = name
        self.groups: dict[str, NeuronGroup] = {}
        self._mapping_count = 0

    def create_neuron_group(
        self,
        name: str,
        neuron_count: int,
        default_config: NeuronConfiguration | None = None,
        *,
        model_attributes: dict | None = None,
        soma_hw_name: str | None = None,
        default_synapse_hw_name: str | None = None,
        dendrite_hw_name: str | None = None,
        log_spikes: bool | None = None,
        log_potential: bool | None = None,
    ) -> NeuronGroup:
        """Create a neuron group. Accepts either a NeuronConfiguration or the
        reference Python module's keyword style (plain-value attribute dicts;
        src/pymodule.cpp:367-387)."""
        if name in self.groups:
            raise ValueError(f"Group: {name} already exists in SNN.")
        if isinstance(default_config, dict):
            # the reference's third positional parameter IS the
            # model-attributes dict (pymodule.cpp:367-387); its scripts
            # pass it positionally
            if model_attributes is not None:
                raise TypeError(
                    "model_attributes given both positionally and by "
                    "keyword"
                )
            model_attributes = default_config
            default_config = None
        if default_config is None:
            attrs = dict(model_attributes or {})
            # reserved keys passed inside model_attributes lift into their
            # dedicated config fields (friendlier than the reference's
            # hard error for the common kwargs style)
            if "log_spikes" in attrs and log_spikes is None:
                log_spikes = bool(attrs.pop("log_spikes"))
            if "log_potential" in attrs and log_potential is None:
                log_potential = bool(attrs.pop("log_potential"))
            if "soma_hw_name" in attrs and soma_hw_name is None:
                soma_hw_name = str(attrs.pop("soma_hw_name"))
            if "synapse_hw_name" in attrs and default_synapse_hw_name is None:
                default_synapse_hw_name = str(attrs.pop("synapse_hw_name"))
            if "dendrite_hw_name" in attrs and dendrite_hw_name is None:
                dendrite_hw_name = str(attrs.pop("dendrite_hw_name"))
            default_config = NeuronConfiguration(
                model_attributes=_wrap_attribute_dict(attrs),
                soma_hw_name=soma_hw_name,
                default_synapse_hw_name=default_synapse_hw_name,
                dendrite_hw_name=dendrite_hw_name,
                log_spikes=log_spikes,
                log_potential=log_potential,
            )
        group = NeuronGroup(name, self, neuron_count, default_config)
        self.groups[name] = group
        return group

    def update_mapping_count(self) -> int:
        self._mapping_count += 1
        return self._mapping_count

    def info(self) -> str:
        return f"sanafe::Network(groups={len(self.groups)})"

    def __getitem__(self, name: str) -> NeuronGroup:
        return self.groups[name]

    def save(self, path: str | Path, use_netlist_format: bool = False) -> None:
        """Serialize network + mappings back to YAML or netlist
        (src/network.hpp:165-178)."""
        path = Path(path)
        if use_netlist_format:
            from .netlist import write_netlist

            write_netlist(path, self)
        else:
            from .yaml_snn import write_network_yaml

            write_network_yaml(path, self)


def load_net(
    path: str | Path, arch: Architecture, use_netlist_format: bool = False
) -> SpikingNetwork:
    """Load an SNN + mapping description (src/network.cpp:194-222)."""
    path = Path(path)
    with path.open("r") as stream:
        if use_netlist_format:
            from .netlist import parse_netlist_file

            return parse_netlist_file(stream, arch)
        from .yaml_snn import parse_network_file

        return parse_network_file(stream, arch)
