"""Lava → sanafe_tpu_torch network converter.

A copy of ``sanafe_tpu/lava.py``, the counterpart to the reference's
``sanafe/lava.py`` bridge: converts Lava ``AbstractProcess`` objects (or
``lava.utils.serialization`` archives) into a
:class:`sanafe_tpu_torch.Network` of LIF groups with dense inter-layer
connectivity, mapped round-robin onto a Loihi-scale architecture.

Requires the ``lava`` package (``lava-nc``); importing this module without
it raises ImportError at call time, not import time.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ._examples import load_loihi
from .attributes import Attribute
from .network import NeuronConfiguration, SpikingNetwork

LOIHI_NEURONS_PER_CORE = 1024

# Lava LIF parameter names → our LIF attribute names
_PARAM_MAP = {
    "vth": "threshold",
    "dv": "leak_decay",
    "du": "input_decay",
    "bias_mant": "bias",
}


def _require_lava():
    try:
        from lava.magma.core.process.process import AbstractProcess
        from lava.utils.serialization import load
    except ImportError as exc:  # pragma: no cover - depends on env
        raise ImportError(
            "The Lava bridge requires the 'lava-nc' package"
        ) from exc
    return AbstractProcess, load


def _process_params(process) -> dict:
    params = getattr(process, "proc_params", None)
    if params is None:
        return {}
    return dict(getattr(params, "_parameters", {}))


def _layer_config(params: dict) -> NeuronConfiguration:
    attrs = {}
    for lava_name, our_name in _PARAM_MAP.items():
        if lava_name in params:
            value = params[lava_name]
            if isinstance(value, np.ndarray):
                value = float(np.asarray(value).ravel()[0])
            if lava_name in ("dv", "du"):
                # Lava decays are "fraction lost"; ours multiply what remains
                value = 1.0 - float(value)
            attrs[our_name] = Attribute(float(value))
    return NeuronConfiguration(model_attributes=attrs)


def _shape_size(params: dict) -> int:
    shape = params.get("shape", (1,))
    return int(np.prod(shape))


def process_to_network(
    processes: Any, arch=None, connect_sequential: bool = True
) -> tuple:
    """Convert Lava process(es) to (arch, net), layers mapped in order."""
    AbstractProcess, _ = _require_lava()
    if isinstance(processes, AbstractProcess):
        processes = [processes]
    arch = arch or load_loihi()
    net = SpikingNetwork("lava_converted")
    cores = arch.cores()
    groups = []
    for index, process in enumerate(processes):
        params = _process_params(process)
        size = _shape_size(params)
        group = net.create_neuron_group(
            f"layer{index}", size, _layer_config(params)
        )
        groups.append(group)
    if connect_sequential:
        for src, dst in zip(groups[:-1], groups[1:]):
            weights = [1.0] * (len(src) * len(dst))
            src.connect_neurons_dense(dst, {"weight": weights})
    core_idx, used = 0, 0
    for group in groups:
        for neuron in group:
            if used >= LOIHI_NEURONS_PER_CORE:
                core_idx += 1
                used = 0
            neuron.map_to_core(cores[core_idx])
            used += 1
    return arch, net


def serial_to_network(filename: str, arch=None) -> tuple:
    """Convert a lava.utils.serialization archive to (arch, net)."""
    _, load = _require_lava()
    archive = load(filename)
    processes = archive[0]
    if not isinstance(processes, (list, tuple)):
        processes = [processes]
    return process_to_network(list(processes), arch=arch)
