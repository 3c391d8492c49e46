"""The check that no JAX and no JAX package is loaded: ``sys.modules`` by
whole top-level name, the part before the first dot."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sanafe_tpu")


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))
