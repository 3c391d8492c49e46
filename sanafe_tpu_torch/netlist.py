"""Legacy netlist (v1) SNN description parser + serializer.

Line-based format kept for back-compatibility with SANA-FE v1
(reference ``src/netlist.cpp``, format spec ``snn/README.md:66-99``)::

    g <neuron count> <attributes>          # neuron group (ids are 0,1,2,...)
    n <gid>.<nid> <attributes>             # per-neuron attributes
    e <gid>.<nid>-><gid>.<nid> <attrs>     # edge (synaptic connection)
    & <gid>.<nid>@<tile>.<core>            # mapping to hardware core

Attributes are ``key=value`` fields; values are type-sniffed
(bool/int/float/string). Embedded YAML-flow values (``{ bias: 0 }`` /
``[0.1, 0.2]``) are also accepted, mirroring the reference's embedded
JSON-ish parsing (src/netlist.cpp:286-414).
"""

from __future__ import annotations

from typing import IO

from .arch import Architecture
from .attributes import Attribute
from .network import NeuronConfiguration, SpikingNetwork
from .yaml_arch import DescriptionParsingError


def _sniff(value: str):
    text = value.strip()
    lowered = text.lower()
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text




def _parse_attribute_fields(
    fields: list[str], line_number: int
) -> dict[str, Attribute]:
    """Parse ``key=value`` attribute fields, including embedded flow-style
    maps/lists spanning multiple fields."""
    attributes: dict[str, Attribute] = {}
    text = " ".join(fields).strip()
    while text:
        if text[0] in "{[":
            # Embedded flow map/list applying multiple attributes, e.g.
            # "{ bias: 0 }" or "[bias: 1.0]"
            close = "}" if text[0] == "{" else "]"
            end = text.find(close)
            if end < 0:
                raise DescriptionParsingError(
                    f"Unterminated embedded value on line {line_number}"
                )
            inner = text[1:end]
            text = text[end + 1 :].strip()
            for item in inner.split(","):
                if not item.strip():
                    continue
                if ":" not in item:
                    raise DescriptionParsingError(
                        f"Invalid embedded attribute {item!r} on line "
                        f"{line_number}"
                    )
                key, _, value = item.partition(":")
                key = key.strip()
                attributes[key] = Attribute(_sniff(value), name=key)
            continue
        part, _, text = text.partition(" ")
        text = text.strip()
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise DescriptionParsingError(
                f"Invalid attribute field {part!r} on line {line_number} "
                "(expected key=value)"
            )
        key, _, raw = part.partition("=")
        if raw.startswith(("{", "[")) and not raw.endswith(("}", "]")):
            # value itself is a flow collection with spaces; rejoin
            close = "}" if raw[1 - 1] == "{" else "]"
            end = text.find(close)
            if end < 0:
                raise DescriptionParsingError(
                    f"Unterminated embedded value on line {line_number}"
                )
            raw = raw + " " + text[: end + 1]
            text = text[end + 1 :].strip()
        # Indexed-looking keys (``time_constant[0]=0.8``) are passed through
        # as literal attribute names: the reference netlist parser has no
        # index syntax, so models receive (and typically warn about) the
        # bracketed name — verified against the reference binary on
        # snn/dendrite.net (MultiTapModel1D keeps zero constants there).
        if raw.startswith("[") and raw.endswith("]"):
            values = [
                Attribute(_sniff(v))
                for v in raw[1:-1].split(",")
                if v.strip()
            ]
            attributes[key] = Attribute(
                [a.value for a in values], name=key
            )
        elif raw.startswith("{") and raw.endswith("}"):
            mapping = {}
            for item in raw[1:-1].split(","):
                if not item.strip():
                    continue
                mkey, _, mval = item.partition(":")
                mapping[mkey.strip()] = _sniff(mval)
            attributes[key] = Attribute(mapping, name=key)
        else:
            attributes[key] = Attribute(_sniff(raw), name=key)
    return attributes


def _to_neuron_config(
    attributes: dict[str, Attribute],
) -> NeuronConfiguration:
    config = NeuronConfiguration()
    for key, attribute in attributes.items():
        if key == "soma_hw_name":
            config.soma_hw_name = attribute.as_str()
        elif key == "synapse_hw_name":
            config.default_synapse_hw_name = attribute.as_str()
        elif key == "dendrite_hw_name":
            config.dendrite_hw_name = attribute.as_str()
        elif key == "log_spikes":
            config.log_spikes = attribute.as_bool()
        elif key in ("log_v", "log_potential"):
            config.log_potential = attribute.as_bool()
        elif key == "connections_out":
            pass  # deprecated reservation hint; connectivity is explicit
        else:
            config.model_attributes[key] = attribute
    return config


def _parse_neuron_address(field: str, line_number: int) -> tuple[str, int]:
    group, dot, neuron = field.partition(".")
    if not dot:
        raise DescriptionParsingError(
            f"Invalid neuron address {field!r} on line {line_number}"
        )
    try:
        return group, int(neuron)
    except ValueError as exc:
        raise DescriptionParsingError(
            f"Invalid neuron id {neuron!r} on line {line_number}"
        ) from exc


def parse_netlist_file(
    stream: IO[str] | str, arch: Architecture
) -> SpikingNetwork:
    if isinstance(stream, str):
        lines = stream.splitlines()
    else:
        lines = stream.read().splitlines()
    net = SpikingNetwork()
    cores = arch.cores()
    core_by_address = {
        (c.address.parent_tile_id, c.address.offset_within_tile): c
        for c in cores
    }
    group_count = 0
    for line_number, raw in enumerate(lines, start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        # strip trailing comment
        hash_pos = line.find(" #")
        if hash_pos >= 0:
            line = line[:hash_pos].rstrip()
        fields = line.split()
        kind = fields[0]
        if kind == "g":
            if len(fields) < 2:
                raise DescriptionParsingError(
                    f"Invalid group entry on line {line_number}"
                )
            try:
                count = int(fields[1])
            except ValueError as exc:
                raise DescriptionParsingError(
                    f"Invalid neuron count {fields[1]!r} on line "
                    f"{line_number}"
                ) from exc
            attributes = _parse_attribute_fields(fields[2:], line_number)
            net.create_neuron_group(
                str(group_count), count, _to_neuron_config(attributes)
            )
            group_count += 1
        elif kind == "n":
            if len(fields) < 2:
                raise DescriptionParsingError(
                    f"Invalid neuron entry on line {line_number}"
                )
            group_id, neuron_id = _parse_neuron_address(
                fields[1], line_number
            )
            if group_id not in net.groups:
                raise DescriptionParsingError(
                    f"Group {group_id} not defined (line {line_number})"
                )
            group = net.groups[group_id]
            if neuron_id >= len(group.neurons):
                raise DescriptionParsingError(
                    f"Neuron {group_id}.{neuron_id} out of range "
                    f"(line {line_number})"
                )
            attributes = _parse_attribute_fields(fields[2:], line_number)
            # The reference's per-NEURON netlist parser forwards attributes
            # without stripping the reserved simulator keys (unlike its
            # group parser, src/netlist.cpp:455-459), so reserved names on
            # 'n' lines throw — verified against the reference binary on
            # snn/hh_example.net and snn/nemo/*.net. Match that behavior.
            for reserved in (
                "soma_hw_name", "default_synapse_hw_name",
                "dendrite_hw_name", "log_spikes", "log_potential", "log_v",
            ):
                if reserved in attributes:
                    raise DescriptionParsingError(
                        f"Reserved neuron attribute '{reserved}' cannot be "
                        "used as a model attribute. Pass it as a direct "
                        "argument instead."
                    )
            group.neurons[neuron_id].set_attributes(
                _to_neuron_config(attributes)
            )
        elif kind == "e":
            if len(fields) < 2 or "->" not in fields[1]:
                raise DescriptionParsingError(
                    f"Invalid edge entry on line {line_number}"
                )
            src_text, _, dest_text = fields[1].partition("->")
            src_group, src_id = _parse_neuron_address(src_text, line_number)
            dest_group, dest_id = _parse_neuron_address(
                dest_text, line_number
            )
            for gid, nid, label in (
                (src_group, src_id, "source"),
                (dest_group, dest_id, "destination"),
            ):
                if gid not in net.groups:
                    raise DescriptionParsingError(
                        f"Edge {label} group {gid} not defined "
                        f"(line {line_number})"
                    )
                if nid >= len(net.groups[gid].neurons):
                    raise DescriptionParsingError(
                        f"Edge {label} neuron {gid}.{nid} out of range "
                        f"(line {line_number})"
                    )
            attributes = _parse_attribute_fields(fields[2:], line_number)
            source = net.groups[src_group].neurons[src_id]
            dest = net.groups[dest_group].neurons[dest_id]
            edge_id = source.connect_to_neuron(dest)
            edge = source.edges_out[edge_id]
            # unscoped attributes forward to both synapse and dendrite
            edge.synapse_attributes.update(attributes)
            edge.dendrite_attributes.update(attributes)
        elif kind == "&":
            if len(fields) < 2 or "@" not in fields[1]:
                raise DescriptionParsingError(
                    f"Invalid mapping entry on line {line_number}"
                )
            neuron_text, _, core_text = fields[1].partition("@")
            group_id, neuron_id = _parse_neuron_address(
                neuron_text, line_number
            )
            tile_text, dot, core_offset_text = core_text.partition(".")
            if not dot:
                raise DescriptionParsingError(
                    f"Invalid core address {core_text!r} on line "
                    f"{line_number}"
                )
            try:
                address = (int(tile_text), int(core_offset_text))
            except ValueError as exc:
                raise DescriptionParsingError(
                    f"Invalid core address {core_text!r} on line "
                    f"{line_number}"
                ) from exc
            if address not in core_by_address:
                raise DescriptionParsingError(
                    f"Core {address[0]}.{address[1]} does not exist "
                    f"(line {line_number})"
                )
            if group_id not in net.groups:
                raise DescriptionParsingError(
                    f"Group {group_id} not defined (line {line_number})"
                )
            group = net.groups[group_id]
            if neuron_id >= len(group.neurons):
                raise DescriptionParsingError(
                    f"Neuron {group_id}.{neuron_id} out of range "
                    f"(line {line_number})"
                )
            group.neurons[neuron_id].map_to_core(core_by_address[address])
        else:
            raise DescriptionParsingError(
                f"Unrecognized netlist entry {kind!r} on line {line_number}"
            )
    return net


def _format_value(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, list):
        return "[" + ",".join(_format_value(v) for v in value) + "]"
    if isinstance(value, dict):
        return (
            "{"
            + ",".join(f"{k}:{_format_value(v)}" for k, v in value.items())
            + "}"
        )
    return str(value)


def write_netlist(path, net: SpikingNetwork) -> None:
    """Serialize network + mappings to netlist format
    (src/netlist.cpp:619-790). Group names map to their creation order."""
    group_index = {name: i for i, name in enumerate(net.groups)}
    lines: list[str] = []
    for name, group in net.groups.items():
        entry = f"g {len(group.neurons)}"
        cfg = group.default_neuron_config
        if cfg.soma_hw_name:
            entry += f" soma_hw_name={cfg.soma_hw_name}"
        if cfg.log_spikes:
            entry += " log_spikes=1"
        if cfg.log_potential:
            entry += " log_v=1"
        for key, attribute in cfg.model_attributes.items():
            entry += f" {key}={_format_value(attribute.value)}"
        lines.append(entry)
    for name, group in net.groups.items():
        gid = group_index[name]
        cfg = group.default_neuron_config
        for neuron in group.neurons:
            entry = f"n {gid}.{neuron.offset}"
            # Reserved simulator fields can only be expressed on 'g' lines:
            # the reference netlist parser rejects them on 'n' lines
            # (src/netlist.cpp neuron path keeps them in model attributes,
            # which network.cpp:119 refuses). Per-neuron values that differ
            # from the group default are unrepresentable — warn and skip.
            divergent = []
            if neuron.soma_hw_name and neuron.soma_hw_name != (
                cfg.soma_hw_name or ""
            ):
                divergent.append("soma_hw_name")
            if neuron.default_synapse_hw_name and (
                neuron.default_synapse_hw_name
                != (cfg.default_synapse_hw_name or "")
            ):
                divergent.append("synapse_hw_name")
            if neuron.dendrite_hw_name and neuron.dendrite_hw_name != (
                cfg.dendrite_hw_name or ""
            ):
                divergent.append("dendrite_hw_name")
            if bool(neuron.log_spikes) != bool(cfg.log_spikes):
                divergent.append("log_spikes")
            if bool(neuron.log_potential) != bool(cfg.log_potential):
                divergent.append("log_v")
            if divergent:
                import warnings

                warnings.warn(
                    f"Neuron {name}.{neuron.offset}: per-neuron "
                    f"{divergent} cannot be expressed in netlist format "
                    "(reserved on 'n' lines); values fall back to the "
                    "group defaults on reload",
                    stacklevel=2,
                )
            for key, attribute in neuron.model_attributes.items():
                entry += f" {key}={_format_value(attribute.value)}"
            lines.append(entry)
    for name, group in net.groups.items():
        gid = group_index[name]
        # hyperedges lowered to arrays (network.py:BulkEdges) expand to
        # single edges, as the YAML writer expands them
        for bulk in group.bulk_edges:
            dest_gid = group_index[bulk.dest_group_name]
            for k in range(len(bulk)):
                entry = (f"e {gid}.{int(bulk.src_idx[k])}->"
                         f"{dest_gid}.{int(bulk.dest_idx[k])}")
                for key, (values, _, _) in bulk.attributes.items():
                    entry += f" {key}={_format_value(float(values[k]))}"
                lines.append(entry)
        for neuron in group.neurons:
            for edge in neuron.edges_out:
                dest_gid = group_index[edge.post_neuron.group_name]
                entry = (
                    f"e {gid}.{neuron.offset}->"
                    f"{dest_gid}.{edge.post_neuron.neuron_offset}"
                )
                merged = dict(edge.dendrite_attributes)
                merged.update(edge.synapse_attributes)
                for key, attribute in merged.items():
                    entry += f" {key}={_format_value(attribute.value)}"
                lines.append(entry)
    # mappings in mapping_order (src/netlist.cpp mapping serialization)
    mapped = [
        (neuron.mapping_order, group_index[name], neuron)
        for name, group in net.groups.items()
        for neuron in group.neurons
        if neuron.core_address is not None
    ]
    mapped.sort(key=lambda entry: entry[0])
    for _, gid, neuron in mapped:
        addr = neuron.core_address
        lines.append(
            f"& {gid}.{neuron.offset}@{addr.parent_tile_id}."
            f"{addr.offset_within_tile}"
        )
    text = "\n".join(lines) + "\n"
    if hasattr(path, "write"):
        path.write(text)
    else:
        with open(path, "w") as stream:
            stream.write(text)
