"""Shared YAML loading utilities.

The reference uses RapidYAML which hands back raw scalar strings and sniffs
types itself in the order int → double → bool → string
(``src/yaml_common.cpp:205+``). PyYAML's default resolver differs (e.g. it
fails on ``1e-9`` floats and eagerly converts ``0.0`` mapping values that the
SNN format needs as core addresses), so we load every scalar as a raw string
and coerce explicitly at each use site via ``coerce_scalar``.

Copy of ``sanafe_tpu/yaml_io.py`` with ``yaml`` imported by the first call
that parses, not by the import of this module: ``sanafe_tpu_torch`` imports
where PyYAML is absent, and only loading a YAML description needs it.
"""

from __future__ import annotations

import functools
from typing import Any, IO


def _yaml():
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            "sanafe_tpu_torch: loading a YAML description needs PyYAML "
            "(the 'yaml' module), which is not installed"
        ) from exc
    return yaml


@functools.cache
def _raw_loader():
    """A safe loader with implicit scalar resolution disabled: all scalars
    load as plain strings (structure resolution is unaffected). The
    libyaml-backed loader when present (scan/parse in C, ~10x faster on
    multi-MB nets); resolution still goes through the Python Resolver
    table, so stripping the implicit resolvers works identically."""
    yaml = _yaml()
    base = getattr(yaml, "CSafeLoader", yaml.SafeLoader)

    class RawLoader(base):
        pass

    # Drop every implicit resolver so scalars stay strings.
    RawLoader.yaml_implicit_resolvers = {}
    return RawLoader


def raw_load(stream: IO[str] | str) -> Any:
    return _yaml().load(stream, Loader=_raw_loader())


def coerce_scalar(value: Any) -> Any:
    """Type-sniff a raw scalar in reference order: int, float, bool, str."""
    if not isinstance(value, str):
        return value
    text = value.strip()
    if not text:
        return value
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    lowered = text.lower()
    if lowered in ("true", "yes"):
        return True
    if lowered in ("false", "no"):
        return False
    return value
