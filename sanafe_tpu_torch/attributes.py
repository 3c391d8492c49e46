"""Model attributes: arbitrary user parameters with forwarding scopes.

Mirrors the reference's recursive ``ModelAttribute`` variant
(``src/attribute.hpp:41-176``): a value that is a bool / int / float / string /
list / dict, plus flags saying which hardware-unit kinds the attribute should
be forwarded to (``forward_to_synapse`` / ``dendrite`` / ``soma``).

In this TPU-native rebuild attributes stay host-side plain Python values; the
compiler lowers them into dense device arrays per model (see ``compile.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Reserved simulator-kernel neuron attributes that models may never implement
# (reference: src/attribute.hpp:24-36).
RESERVED_NEURON_ATTRIBUTES = frozenset(
    {
        "soma_hw_name",
        "default_synapse_hw_name",
        "dendrite_hw_name",
        "log_spikes",
        "log_potential",
        "log_v",
    }
)


def is_reserved_neuron_attribute(name: str) -> bool:
    return name in RESERVED_NEURON_ATTRIBUTES


@dataclass
class Attribute:
    """One named model attribute with unit-forwarding scope flags."""

    value: Any
    forward_to_synapse: bool = True
    forward_to_dendrite: bool = True
    forward_to_soma: bool = True
    name: str | None = None

    # --- casts mirroring ModelAttribute's conversion operators ---
    def as_bool(self) -> bool:
        if isinstance(self.value, bool):
            return self.value
        if isinstance(self.value, int):
            return self.value != 0
        if isinstance(self.value, str):
            lowered = self.value.strip().lower()
            if lowered in ("true", "yes", "on", "1"):
                return True
            if lowered in ("false", "no", "off", "0"):
                return False
        raise TypeError(f"Attribute {self.name!r} cannot cast to bool: {self.value!r}")

    def as_int(self) -> int:
        if isinstance(self.value, bool):
            return int(self.value)
        if isinstance(self.value, (int, float)):
            return int(self.value)
        if isinstance(self.value, str):
            return int(self.value.strip())
        raise TypeError(f"Attribute {self.name!r} cannot cast to int: {self.value!r}")

    def as_float(self) -> float:
        if isinstance(self.value, (int, float)) and not isinstance(self.value, bool):
            return float(self.value)
        if isinstance(self.value, bool):
            return float(self.value)
        if isinstance(self.value, str):
            return float(self.value.strip())
        raise TypeError(f"Attribute {self.name!r} cannot cast to float: {self.value!r}")

    def as_str(self) -> str:
        if isinstance(self.value, str):
            return self.value
        return str(self.value)

    def as_list(self) -> list["Attribute"]:
        if isinstance(self.value, list):
            return [v if isinstance(v, Attribute) else Attribute(v) for v in self.value]
        raise TypeError(f"Attribute {self.name!r} is not a list: {self.value!r}")

    def as_float_list(self) -> list[float]:
        return [a.as_float() for a in self.as_list()]

    def as_int_list(self) -> list[int]:
        return [a.as_int() for a in self.as_list()]

    def as_bool_list(self) -> list[bool]:
        out = []
        for a in self.as_list():
            v = a.value
            if isinstance(v, (bool, int)):
                out.append(bool(v))
            else:
                out.append(a.as_bool())
        return out

    def plain(self) -> Any:
        """Recursively strip Attribute wrappers back to plain Python values."""
        if isinstance(self.value, list):
            vals = [v.plain() if isinstance(v, Attribute) else v for v in self.value]
            names = [
                v.name if isinstance(v, Attribute) else None for v in self.value
            ]
            if any(n is not None for n in names):
                return {n: v for n, v in zip(names, vals)}
            return vals
        return self.value


def wrap_attribute(value: Any, name: str | None = None) -> Attribute:
    """Wrap a plain Python value (possibly nested) as an Attribute tree."""
    if isinstance(value, Attribute):
        if name is not None and value.name is None:
            value.name = name
        return value
    if isinstance(value, dict):
        children = [wrap_attribute(v, k) for k, v in value.items()]
        return Attribute(children, name=name)
    if isinstance(value, (list, tuple)):
        children = [wrap_attribute(v) for v in value]
        return Attribute(children, name=name)
    return Attribute(value, name=name)


def wrap_attribute_map(values: dict[str, Any]) -> dict[str, Attribute]:
    return {k: wrap_attribute(v, k) for k, v in values.items()}


@dataclass
class ScopedAttributes:
    """Attributes split by forwarding scope, as parsed from descriptions.

    The SNN YAML format lets shared attributes sit alongside unit-scoped
    ``synapse:`` / ``dendrite:`` / ``soma:`` subsections
    (``src/yaml_snn.cpp:331-394``); scoped entries only forward to that unit.
    """

    shared: dict[str, Attribute] = field(default_factory=dict)
    synapse: dict[str, Attribute] = field(default_factory=dict)
    dendrite: dict[str, Attribute] = field(default_factory=dict)
    soma: dict[str, Attribute] = field(default_factory=dict)

    def merged(self) -> dict[str, Attribute]:
        """Flatten into one map with forwarding flags set per scope."""
        out: dict[str, Attribute] = {}
        for key, attr in self.shared.items():
            out[key] = attr
        for scope_name in ("synapse", "dendrite", "soma"):
            for key, attr in getattr(self, scope_name).items():
                scoped = Attribute(
                    attr.value,
                    forward_to_synapse=(scope_name == "synapse"),
                    forward_to_dendrite=(scope_name == "dendrite"),
                    forward_to_soma=(scope_name == "soma"),
                    name=attr.name or key,
                )
                out[key] = scoped
        return out
