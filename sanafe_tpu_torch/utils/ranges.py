"""Range-notation helpers for description files.

The reference expands ``name[0..7]`` style ranges in architecture descriptions
(``src/yaml_common.hpp:110``, ``src/yaml_arch.cpp:380-423``) and ``0..7`` spans
in SNN neuron/mapping sections (``src/yaml_snn.cpp:226-278``).
"""

from __future__ import annotations

RANGE_DELIMITER = ".."


def has_range(text: str) -> bool:
    return RANGE_DELIMITER in text


def parse_range(text: str) -> tuple[int, int]:
    """Parse a ``"A..B"`` span, optionally wrapped in brackets.

    Accepts ``"0..7"``, ``"[0..7]"``, and ``"name[0..7]"`` forms; returns the
    inclusive (first, last) pair. Raises ValueError on malformed input,
    matching the reference's strict parsing (``src/yaml_common.cpp``).
    """
    span = text
    if "[" in span:
        open_idx = span.find("[")
        close_idx = span.find("]", open_idx)
        if close_idx < 0:
            raise ValueError(f"Malformed range (missing ']'): {text!r}")
        span = span[open_idx + 1 : close_idx]
    if RANGE_DELIMITER not in span:
        raise ValueError(f"Not a range: {text!r}")
    first_str, _, last_str = span.partition(RANGE_DELIMITER)
    try:
        first = int(first_str)
        last = int(last_str)
    except ValueError as exc:
        raise ValueError(f"Invalid range bounds in {text!r}") from exc
    if last < first:
        raise ValueError(f"Range end before start: {text!r}")
    return first, last


def expand_name_range(name: str) -> list[str]:
    """Expand ``"tile[0..3]"`` to ``["tile[0]", ..., "tile[3]"]``.

    A name without a range expands to itself (single-element list).
    """
    if not has_range(name):
        return [name]
    first, last = parse_range(name)
    base = name[: name.find("[")]
    return [f"{base}[{i}]" for i in range(first, last + 1)]
