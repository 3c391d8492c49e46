"""YAML SNN description parser and serializer.

Host-side equivalent of the reference's ``src/yaml_snn.cpp``:

- ``network:`` section with ``groups`` (neuron-count pre-pass supporting
  ``0..N`` ranges, per-neuron attributes layered over group defaults,
  unit-scoped ``dendrite:`` / ``soma:`` subsections) and ``edges``
  (``"a.0 -> b.1"`` single edges and group-level ``type: conv2d|dense|sparse``
  hyperedges with per-kernel / per-edge attribute lists).
- ``mappings:`` section mapping neuron(-ranges) to ``core: t.c`` with optional
  explicit synapse/dendrite/soma unit selection.
- Serialization back to YAML with run-length-compressed neuron runs
  (``src/yaml_snn.cpp:1058-1548``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, IO

from .arch import Architecture
from .attributes import Attribute
from .network import (
    Conv2DParameters,
    NeuronConfiguration,
    NeuronGroup,
    SpikingNetwork,
)
from .yaml_arch import DescriptionParsingError, parse_attribute, parse_model_attributes
from .utils.ranges import parse_range
from .yaml_io import coerce_scalar, raw_load


# --- parsing -----------------------------------------------------------------

def parse_network_file(stream: IO[str] | str, arch: Architecture) -> SpikingNetwork:
    doc = raw_load(stream)
    if not isinstance(doc, dict):
        raise DescriptionParsingError("Mapped network file has invalid format")
    if "network" not in doc:
        raise DescriptionParsingError("No top-level 'network' section defined")
    net = parse_network_section(doc["network"])
    if "mappings" not in doc:
        raise DescriptionParsingError("No 'mappings' section defined")
    parse_mapping_section(doc["mappings"], arch, net)
    return net


def parse_network_section(net_node: dict) -> SpikingNetwork:
    name = str(net_node.get("name", ""))
    if "[" in name:
        raise DescriptionParsingError("Multiple networks not supported")
    if "groups" not in net_node:
        raise DescriptionParsingError("No neuron groups specified")
    if "edges" not in net_node:
        raise DescriptionParsingError("No edges section specified")
    net = SpikingNetwork(name)
    _parse_group_section(net_node["groups"], net)
    _parse_edges_section(net_node["edges"], net)
    return net


def _parse_group_section(groups_node: Any, net: SpikingNetwork) -> None:
    if not isinstance(groups_node, list):
        raise DescriptionParsingError(
            "Neuron group section does not define a list of groups"
        )
    for group_node in groups_node:
        _parse_group(group_node, net)


def _parse_group(group_node: dict, net: SpikingNetwork) -> None:
    if "name" not in group_node:
        raise DescriptionParsingError("Missing group name")
    group_name = str(group_node["name"])
    if "neurons" not in group_node:
        raise DescriptionParsingError("No neurons section defined.")
    neurons_node = group_node["neurons"]
    neuron_count = _count_neurons(neurons_node)
    default_config = NeuronConfiguration()
    if "attributes" in group_node and group_node["attributes"] is not None:
        default_config = parse_neuron_attributes(
            group_node["attributes"], default_config
        )
    group = net.create_neuron_group(group_name, neuron_count, default_config)
    _parse_neuron_section(neurons_node, group)


def _count_neurons(neurons_node: Any) -> int:
    """Pre-pass over the neurons list counting ranges
    (src/yaml_snn.cpp:226-278)."""
    if not isinstance(neurons_node, list):
        raise DescriptionParsingError("Invalid neuron format, should be list")
    count = 0
    for entry in neurons_node:
        if isinstance(entry, (dict, list)):
            keys = entry.keys() if isinstance(entry, dict) else entry
            for key in keys:
                key = str(key)
                if ".." in key:
                    first, last = parse_range(key)
                    count += last - first + 1
                else:
                    count += 1
        else:
            key = str(entry)
            if ".." in key:
                first, last = parse_range(key)
                count += last - first + 1
            else:
                count += 1
    return count


def _parse_neuron_section(neurons_node: list, group: NeuronGroup) -> None:
    if not isinstance(neurons_node, list):
        raise DescriptionParsingError("Invalid neuron format, should be list")
    for entry in neurons_node:
        if isinstance(entry, dict):
            for key, attributes_node in entry.items():
                _parse_neuron(str(key), attributes_node, group)
        elif isinstance(entry, str):
            # Bare id / range with no attributes (e.g. "- 0..15")
            _parse_neuron(entry, None, group)
        else:
            raise DescriptionParsingError(
                "Each neuron entry must map an id (or range) to attributes"
            )


def _parse_neuron(neuron_id: str, attributes_node: Any, group: NeuronGroup) -> None:
    config = parse_neuron_attributes(
        attributes_node, group.default_neuron_config
    )
    if ".." in neuron_id:
        first, last = parse_range(neuron_id)
        for instance in range(first, last + 1):
            group.neurons[instance].set_attributes(config)
    else:
        group.neurons[int(neuron_id)].set_attributes(config)


def parse_neuron_attributes(
    attributes_node: Any, default_template: NeuronConfiguration | None = None
) -> NeuronConfiguration:
    """Layer neuron attributes over a template (src/yaml_snn.cpp:304-394)."""
    template = (default_template or NeuronConfiguration()).copy()
    if attributes_node is None or attributes_node == "":
        return template
    if isinstance(attributes_node, list):
        for attribute in attributes_node:
            template = parse_neuron_attributes(attribute, template)
        return template
    if not isinstance(attributes_node, dict):
        raise DescriptionParsingError(
            f"Invalid neuron attributes: {attributes_node!r}"
        )

    if "log_potential" in attributes_node:
        template.log_potential = _coerce_bool(attributes_node["log_potential"])
    if "log_spikes" in attributes_node:
        template.log_spikes = _coerce_bool(attributes_node["log_spikes"])
    if "synapse_hw_name" in attributes_node:
        template.default_synapse_hw_name = str(attributes_node["synapse_hw_name"])
    if "dendrite_hw_name" in attributes_node:
        template.dendrite_hw_name = str(attributes_node["dendrite_hw_name"])
    if "soma_hw_name" in attributes_node:
        template.soma_hw_name = str(attributes_node["soma_hw_name"])

    # Shared attributes forward everywhere (src/yaml_snn.cpp:358-369)
    for key, attribute in parse_model_attributes(attributes_node).items():
        attribute.forward_to_dendrite = True
        attribute.forward_to_soma = True
        template.model_attributes[key] = attribute
    # Unit-scoped subsections restrict forwarding (src/yaml_snn.cpp:370-394)
    if "dendrite" in attributes_node:
        for key, attribute in parse_model_attributes(
            attributes_node["dendrite"]
        ).items():
            attribute.forward_to_synapse = False
            attribute.forward_to_soma = False
            template.model_attributes[key] = attribute
    if "soma" in attributes_node:
        for key, attribute in parse_model_attributes(
            attributes_node["soma"]
        ).items():
            attribute.forward_to_synapse = False
            attribute.forward_to_dendrite = False
            template.model_attributes[key] = attribute
    return template


def _coerce_bool(value: Any) -> bool:
    value = coerce_scalar(value)
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return value != 0
    raise DescriptionParsingError(f"Expected bool, got {value!r}")


# --- edges -------------------------------------------------------------------

def _parse_edges_section(edges_node: Any, net: SpikingNetwork) -> None:
    if not isinstance(edges_node, list):
        raise DescriptionParsingError(
            "Edges section does not define a list of edges"
        )
    for entry in edges_node:
        if not isinstance(entry, dict):
            raise DescriptionParsingError(
                "Each edge entry must map a description to attributes"
            )
        for description, attributes_node in entry.items():
            _parse_edge(str(description), attributes_node, net)


def _split_edge_description(description: str) -> tuple:
    """Parse ``"a.0 -> b.1"`` or ``"a -> b"`` (src/yaml_snn.cpp:396-448)."""
    if "->" not in description:
        raise DescriptionParsingError(
            f"Edge is not formatted correctly: {description}"
        )
    source_part, _, target_part = description.partition("->")
    source_part = source_part.strip()
    target_part = target_part.strip()
    src_dot = source_part.find(".")
    tgt_dot = target_part.find(".")
    if (src_dot >= 0) != (tgt_dot >= 0):
        raise DescriptionParsingError(
            f"No target neuron defined in edge:{description}"
        )
    if src_dot >= 0:
        return (
            source_part[:src_dot],
            int(source_part[src_dot + 1 :]),
            target_part[:tgt_dot],
            int(target_part[tgt_dot + 1 :]),
        )
    return source_part, None, target_part, None


def _parse_edge(description: str, attributes_node: Any, net: SpikingNetwork) -> None:
    src_group_name, src_offset, tgt_group_name, tgt_offset = (
        _split_edge_description(description)
    )
    if src_group_name not in net.groups:
        raise DescriptionParsingError(
            f"Invalid source neuron group:{src_group_name}"
        )
    if tgt_group_name not in net.groups:
        raise DescriptionParsingError(
            f"Invalid target neuron group:{tgt_group_name}"
        )
    source_group = net.groups[src_group_name]
    target_group = net.groups[tgt_group_name]

    if src_offset is None:
        _parse_hyperedge(source_group, target_group, attributes_node)
        return

    if src_offset >= len(source_group.neurons):
        raise DescriptionParsingError(
            f"Invalid source neuron id: {src_group_name}.{src_offset}"
        )
    if tgt_offset >= len(target_group.neurons):
        raise DescriptionParsingError(
            f"Invalid target neuron id: {tgt_group_name}.{tgt_offset}"
        )
    source = source_group.neurons[src_offset]
    target = target_group.neurons[tgt_offset]
    edge = source.edges_out[source.connect_to_neuron(target)]
    _parse_edge_attributes(edge, attributes_node)


def _parse_edge_attributes(edge, attributes_node: Any) -> None:
    """Single-edge attributes with optional synapse/dendrite scoping
    (src/yaml_snn.cpp:831-878)."""
    if attributes_node is None or attributes_node == "":
        return
    if isinstance(attributes_node, list):
        for attribute in attributes_node:
            _parse_edge_attributes(edge, attribute)
        return
    if not isinstance(attributes_node, dict):
        raise DescriptionParsingError(
            f"Invalid edge attributes: {attributes_node!r}"
        )
    if "synapse" in attributes_node:
        for key, attribute in parse_model_attributes(
            attributes_node["synapse"]
        ).items():
            attribute.forward_to_dendrite = False
            attribute.forward_to_soma = False
            edge.synapse_attributes[key] = attribute
    if "dendrite" in attributes_node:
        for key, attribute in parse_model_attributes(
            attributes_node["dendrite"]
        ).items():
            attribute.forward_to_synapse = False
            attribute.forward_to_soma = False
            edge.dendrite_attributes[key] = attribute
    for key, attribute in parse_model_attributes(attributes_node).items():
        if key not in ("synapse", "dendrite", "soma"):
            edge.synapse_attributes[key] = attribute
            edge.dendrite_attributes[key] = attribute


def _flatten_attr_node(attributes_node: Any) -> dict:
    """Fold a list-of-maps attributes node into one dict."""
    if attributes_node is None or attributes_node == "":
        return {}
    if isinstance(attributes_node, dict):
        return dict(attributes_node)
    if isinstance(attributes_node, list):
        flat: dict = {}
        for item in attributes_node:
            flat.update(_flatten_attr_node(item))
        return flat
    raise DescriptionParsingError(f"Invalid attributes: {attributes_node!r}")


def _parse_hyperedge(
    source_group: NeuronGroup, target_group: NeuronGroup, attributes_node: Any
) -> None:
    """Group-level hyperedges: conv2d / dense / sparse
    (src/yaml_snn.cpp:552-829)."""
    flat = _flatten_attr_node(attributes_node)
    edge_type = str(flat.get("type", ""))
    if not edge_type:
        raise DescriptionParsingError("No hyperedge type specified.")

    if edge_type == "conv2d":
        conv = Conv2DParameters()
        conv_keys = {
            "input_height",
            "input_width",
            "input_channels",
            "kernel_width",
            "kernel_height",
            "kernel_count",
            "stride_width",
            "stride_height",
        }
        attribute_lists: dict[str, list[Attribute]] = {}
        for key, value in flat.items():
            if key in conv_keys:
                setattr(conv, key, int(coerce_scalar(value)))
            elif key == "type" or key in ("synapse", "dendrite", "soma"):
                continue
            else:
                attribute_lists[key] = _parse_attribute_list(key, value)
        _apply_scoped_hyperedge_lists(attribute_lists, attributes_node)
        source_group.connect_neurons_conv2d(target_group, attribute_lists, conv)
    elif edge_type == "dense":
        attribute_lists = {
            key: _parse_attribute_list(key, value)
            for key, value in flat.items()
            if key != "type" and key not in ("synapse", "dendrite", "soma")
        }
        _apply_scoped_hyperedge_lists(attribute_lists, attributes_node)
        source_group.connect_neurons_dense(target_group, attribute_lists)
    elif edge_type == "sparse":
        pairs: list[tuple[int, int]] = []
        attribute_lists = {}
        for key, value in flat.items():
            if key == "type" or key in ("synapse", "dendrite", "soma"):
                continue
            if key == "source_target_pairs":
                if not isinstance(value, list):
                    raise DescriptionParsingError(
                        "Source/target pair must be a list of pairs"
                    )
                for pair in value:
                    if not isinstance(pair, list) or len(pair) != 2:
                        raise DescriptionParsingError(
                            "Invalid source/target format: "
                            "expected [source, target]"
                        )
                    pairs.append(
                        (int(coerce_scalar(pair[0])), int(coerce_scalar(pair[1])))
                    )
            else:
                attribute_lists[key] = _parse_attribute_list(key, value)
        _apply_scoped_hyperedge_lists(attribute_lists, attributes_node)
        source_group.connect_neurons_sparse(target_group, attribute_lists, pairs)
    else:
        raise DescriptionParsingError(f"Invalid hyperedge type: {edge_type}")


def _parse_attribute_list(key: str, value: Any) -> list[Attribute]:
    if not isinstance(value, list):
        raise DescriptionParsingError(
            "Attribute must be a list with an entry for each connection "
            f"(name: {key})"
        )
    return [parse_attribute(v, key) for v in value]


def _apply_scoped_hyperedge_lists(
    attribute_lists: dict[str, list[Attribute]], attributes_node: Any
) -> None:
    """Handle synapse/dendrite/soma-scoped per-edge attribute lists inside
    hyperedges (src/yaml_snn.cpp:694-733)."""
    flat = _flatten_attr_node(attributes_node)
    for scope in ("synapse", "dendrite", "soma"):
        if scope not in flat:
            continue
        scoped_node = flat[scope]
        if not isinstance(scoped_node, dict):
            raise DescriptionParsingError(
                f"Scoped hyperedge attributes must be a map: {scope}"
            )
        for key, value in scoped_node.items():
            entries = _parse_attribute_list(str(key), value)
            for attribute in entries:
                attribute.forward_to_synapse = scope == "synapse"
                attribute.forward_to_dendrite = scope == "dendrite"
                attribute.forward_to_soma = scope == "soma"
            attribute_lists[str(key)] = entries


# --- mappings ----------------------------------------------------------------

def parse_mapping_section(
    mappings_node: Any, arch: Architecture, net: SpikingNetwork
) -> None:
    """Parse the ``mappings:`` section (src/yaml_snn.cpp:880-1056)."""
    if not isinstance(mappings_node, list):
        raise DescriptionParsingError(
            "Mappings must be given as a sequence / list."
        )
    cores = arch.cores()
    del cores  # validated per-mapping below
    for mapping in mappings_node:
        if not isinstance(mapping, dict):
            raise DescriptionParsingError(
                "Expected mapping to be defined in the format: "
                "<group>.<neuron>: [<attributes>]"
            )
        if len(mapping) != 1:
            raise DescriptionParsingError("Should be one entry per mapping")
        for neuron_address, info in mapping.items():
            _parse_mapping(str(neuron_address), info, arch, net)


def _parse_mapping(
    neuron_address: str, info: Any, arch: Architecture, net: SpikingNetwork
) -> None:
    dot = neuron_address.find(".")
    group_name = neuron_address[:dot] if dot >= 0 else neuron_address
    if group_name not in net.groups:
        raise DescriptionParsingError(
            f"While mapping, group not found ({group_name})"
        )
    group = net.groups[group_name]
    if dot >= 0:
        neuron_str = neuron_address[dot + 1 :]
        if ".." in neuron_str:
            start_id, end_id = parse_range(neuron_str)
        else:
            start_id = end_id = int(neuron_str)
    else:
        start_id, end_id = 0, len(group.neurons) - 1

    for offset in range(start_id, end_id + 1):
        if offset >= len(group.neurons):
            raise DescriptionParsingError(
                f"Invalid neuron id: {group.name}.{offset}"
            )
        _map_neuron(group.neurons[offset], info, arch)


def _map_neuron(neuron, info: Any, arch: Architecture) -> None:
    core_address = ""
    entries = info if isinstance(info, list) else [info]
    for entry in entries:
        if not isinstance(entry, dict):
            raise DescriptionParsingError("Expected attributes to be map")
        if "synapse" in entry:
            neuron.default_synapse_hw_name = str(entry["synapse"])
        if "dendrite" in entry:
            neuron.dendrite_hw_name = str(entry["dendrite"])
        if "soma" in entry:
            neuron.soma_hw_name = str(entry["soma"])
        if "core" in entry:
            core_address = str(entry["core"])
    dot = core_address.find(".")
    if dot < 0:
        raise DescriptionParsingError(
            f"Invalid core address in mapping: {core_address!r}"
        )
    tile_id = int(core_address[:dot])
    core_offset = int(core_address[dot + 1 :])
    if tile_id >= len(arch.tiles):
        raise DescriptionParsingError("Tile ID >= tile count")
    tile = arch.tiles[tile_id]
    if core_offset >= len(tile.cores):
        raise DescriptionParsingError("Core ID >= core count")
    neuron.map_to_core(tile.cores[core_offset])


# --- serialization -----------------------------------------------------------

def _attr_to_plain(attribute: Attribute) -> Any:
    return attribute.plain()


def _format_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return value
    if isinstance(value, list):
        return "[" + ", ".join(_format_value(v) for v in value) + "]"
    if isinstance(value, dict):
        return (
            "{"
            + ", ".join(f"{k}: {_format_value(v)}" for k, v in value.items())
            + "}"
        )
    return str(value)


def _neuron_attribute_signature(neuron) -> tuple:
    scoped: list[tuple] = []
    for key, attribute in sorted(neuron.model_attributes.items()):
        scoped.append(
            (
                key,
                repr(attribute.plain()),
                attribute.forward_to_synapse,
                attribute.forward_to_dendrite,
                attribute.forward_to_soma,
            )
        )
    return (
        neuron.soma_hw_name,
        neuron.default_synapse_hw_name,
        neuron.dendrite_hw_name,
        neuron.log_spikes,
        neuron.log_potential,
        tuple(scoped),
    )


def _emit_neuron_attributes(neuron, group) -> dict:
    out: dict[str, Any] = {}
    defaults = group.default_neuron_config
    if neuron.log_spikes != bool(defaults.log_spikes or False):
        out["log_spikes"] = neuron.log_spikes
    if neuron.log_potential != bool(defaults.log_potential or False):
        out["log_potential"] = neuron.log_potential
    if neuron.soma_hw_name and neuron.soma_hw_name != (
        defaults.soma_hw_name or ""
    ):
        out["soma_hw_name"] = neuron.soma_hw_name
    if neuron.default_synapse_hw_name and neuron.default_synapse_hw_name != (
        defaults.default_synapse_hw_name or ""
    ):
        out["synapse_hw_name"] = neuron.default_synapse_hw_name
    if neuron.dendrite_hw_name and neuron.dendrite_hw_name != (
        defaults.dendrite_hw_name or ""
    ):
        out["dendrite_hw_name"] = neuron.dendrite_hw_name
    shared: dict[str, Any] = {}
    soma_scope: dict[str, Any] = {}
    dendrite_scope: dict[str, Any] = {}
    for key, attribute in neuron.model_attributes.items():
        default_attr = defaults.model_attributes.get(key)
        if default_attr is not None and repr(default_attr.plain()) == repr(
            attribute.plain()
        ):
            continue
        if attribute.forward_to_soma and not attribute.forward_to_dendrite:
            soma_scope[key] = attribute.plain()
        elif attribute.forward_to_dendrite and not attribute.forward_to_soma:
            dendrite_scope[key] = attribute.plain()
        else:
            shared[key] = attribute.plain()
    out.update(shared)
    if soma_scope:
        out["soma"] = soma_scope
    if dendrite_scope:
        out["dendrite"] = dendrite_scope
    return out


def write_network_yaml(path: str | Path, net: SpikingNetwork) -> None:
    """Serialize a network + mappings to YAML with run-length-compressed
    neuron runs (src/yaml_snn.cpp:1058-1548)."""
    lines: list[str] = []
    lines.append("network:")
    lines.append(f"  name: {net.name}")
    lines.append("  groups:")
    for group in net.groups.values():
        lines.append(f"    - name: {group.name}")
        defaults = group.default_neuron_config
        attr_items: dict[str, Any] = {}
        if defaults.log_spikes:
            attr_items["log_spikes"] = defaults.log_spikes
        if defaults.log_potential:
            attr_items["log_potential"] = defaults.log_potential
        if defaults.soma_hw_name:
            attr_items["soma_hw_name"] = defaults.soma_hw_name
        if defaults.default_synapse_hw_name:
            attr_items["synapse_hw_name"] = defaults.default_synapse_hw_name
        if defaults.dendrite_hw_name:
            attr_items["dendrite_hw_name"] = defaults.dendrite_hw_name
        for key, attribute in defaults.model_attributes.items():
            attr_items[key] = attribute.plain()
        lines.append(f"      attributes: {_format_value(attr_items)}")
        lines.append("      neurons:")
        # Run-length compress identical consecutive neuron configurations
        run_start = 0
        neurons = group.neurons
        while run_start < len(neurons):
            run_end = run_start
            signature = _neuron_attribute_signature(neurons[run_start])
            while (
                run_end + 1 < len(neurons)
                and _neuron_attribute_signature(neurons[run_end + 1]) == signature
            ):
                run_end += 1
            attrs = _emit_neuron_attributes(neurons[run_start], group)
            key = (
                f"{run_start}..{run_end}" if run_end > run_start else f"{run_start}"
            )
            lines.append(f"        - {key}: {_format_value(attrs)}")
            run_start = run_end + 1
    lines.append("  edges:")
    for group in net.groups.values():
        # Bulk hyperedges (vectorized conv2d/dense) expand to single edges
        # on save, matching the reference's per-edge serialization
        for bulk in getattr(group, "bulk_edges", []):  # noqa: B007
            for k in range(len(bulk)):
                attrs = {
                    key: float(values[k])
                    for key, (values, _, _) in bulk.attributes.items()
                }
                description = (
                    f"{group.name}.{int(bulk.src_idx[k])}"
                    f" -> {bulk.dest_group_name}.{int(bulk.dest_idx[k])}"
                )
                lines.append(f"    - {description}: {_format_value(attrs)}")
        for neuron in group.neurons:
            for edge in neuron.edges_out:
                attrs: dict[str, Any] = {}
                synapse_only = {}
                dendrite_only = {}
                for key, attribute in edge.synapse_attributes.items():
                    if key in edge.dendrite_attributes and repr(
                        edge.dendrite_attributes[key].plain()
                    ) == repr(attribute.plain()):
                        attrs[key] = attribute.plain()
                    else:
                        synapse_only[key] = attribute.plain()
                for key, attribute in edge.dendrite_attributes.items():
                    if key not in attrs and key not in synapse_only:
                        dendrite_only[key] = attribute.plain()
                if synapse_only:
                    attrs["synapse"] = synapse_only
                if dendrite_only:
                    attrs["dendrite"] = dendrite_only
                description = (
                    f"{edge.pre_neuron.group_name}.{edge.pre_neuron.neuron_offset}"
                    f" -> {edge.post_neuron.group_name}."
                    f"{edge.post_neuron.neuron_offset}"
                )
                lines.append(f"    - {description}: {_format_value(attrs)}")
    lines.append("mappings:")
    # Emit mappings in mapping_order (matching reference load/save semantics)
    mapped = [
        neuron
        for group in net.groups.values()
        for neuron in group.neurons
        if neuron.core_address is not None
    ]
    mapped.sort(key=lambda n: n.mapping_order)
    for neuron in mapped:
        address = neuron.core_address
        entry = {
            "core": f"{address.parent_tile_id}.{address.offset_within_tile}"
        }
        lines.append(
            f"  - {neuron.parent_group_name}.{neuron.offset}: "
            f"{_format_value(entry)}"
        )
    Path(path).write_text("\n".join(lines) + "\n")
