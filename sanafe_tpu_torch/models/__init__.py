"""Hardware-unit model registry.

The reference binds model names to C++ ``PipelineUnit`` subclasses via a
factory (``src/models.cpp:933-967``) and loads extra models from ``dlopen``
plugins (``src/plugins.cpp``). Here a model is a declarative ``ModelSpec``:
capability flags plus the attribute schema, consumed by the compiler
(``compile.py``) which lowers per-neuron/per-edge attributes into dense device
arrays. Python-registered models replace the dlopen plugin mechanism (see
``register_soma_model`` and ``sanafe_tpu_torch/plugins.py``); their update
functions take and return torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

# Model ids used in device arrays for soma dispatch
SOMA_MODEL_NONE = -1
SOMA_MODEL_LIF = 0
SOMA_MODEL_TRUENORTH = 1
SOMA_MODEL_INPUT = 2
SOMA_MODEL_PLUGIN_BASE = 16

DENDRITE_MODEL_ACCUMULATOR = 0
DENDRITE_MODEL_ACCUMULATOR_DELAY = 1
DENDRITE_MODEL_MULTITAP = 2
# Plugin models with per-edge compartment routing (combined dendrite+soma
# units like NeuroFEM); edges carry a 'compartment' attribute
DENDRITE_MODEL_PLUGIN_COMP = 3

SYNAPSE_MODEL_CURRENT_BASED = 0

# Hard limits mirroring the reference
LOIHI_MAX_COMPARTMENTS = 1024  # src/models.hpp:29
TRUENORTH_MAX_NEURONS = 4096  # src/models.hpp:284
ACCUMULATOR_MAX_DELAY = 5  # src/models.hpp (AccumulatorWithDelayModel)


@dataclass
class ModelSpec:
    """Declarative description of one hardware-unit model."""

    name: str
    implements_synapse: bool = False
    implements_dendrite: bool = False
    implements_soma: bool = False
    # Attribute names the model recognizes (for warning parity with
    # PipelineUnit::check_attribute; src/pipeline.cpp:124-149)
    attributes: dict[str, str] = field(default_factory=dict)
    soma_model_id: int = SOMA_MODEL_NONE
    dendrite_model_id: int = -1
    synapse_model_id: int = -1
    # --- Python-plugin soma models (replacing the reference's dlopen
    # plugins, src/plugins.cpp): a vectorized update over per-neuron
    # parameter/state arrays ---
    # signature: update(params, state, valid, current, t)
    #   -> (new_state: dict, fired: bool[N], updated: bool[N],
    #       potential: float[N]); t is a 0-d int64 tensor on the device
    soma_update: Optional[Callable] = None
    # per-neuron parameters: name -> default (settable via neuron attrs)
    param_defaults: dict[str, float] = field(default_factory=dict)
    # per-neuron state variables: name -> initial value
    state_init: dict[str, float] = field(default_factory=dict)
    # >0 for combined dendrite+soma plugins routing per-edge inputs into
    # K compartments (edge attribute 'compartment'); the update function
    # then receives comp: [N, K] with last step's per-compartment sums
    dendrite_compartments: int = 0
    # True when the reference plugin keeps ONE state for the whole hardware
    # unit (ignores neuron_address, e.g. plugins/hodgkin_huxley.cpp:38-43):
    # every mapped neuron's update advances the same sequence, one call per
    # neuron per timestep. Only meaningful for models that also ignore the
    # synaptic input. Emulated per-neuron via rank/stride (see ops/step.py).
    shared_unit_state: bool = False
    # feed(params, t0, length, lanes) -> [length, len(lanes)] array or
    # None: the update's host inputs for a chunk, built once a chunk; the
    # update then takes ``feed=``, its step's row (see register_soma_model)
    feed: Optional[Callable] = None


# Framework attributes recognized by every unit (src/pipeline.hpp:182-205)
FRAMEWORK_ATTRIBUTES = {
    "force_update": "(bool) Force updates every time-step.",
    "synapse_hw_name": "(str) Unique name of the synapse H/W unit.",
    "dendrite_hw_name": "(str) Unique name of the dendrite H/W unit.",
    "soma_hw_name": "(str) Unique name of the soma H/W unit.",
    "model": "(str) Unique model name, either built-in or plugin.",
    "plugin": "(str) Plug-in library path.",
    "energy_message_in": "",
    "latency_message_in": "",
    "energy_access_neuron": "",
    "latency_access_neuron": "",
    "energy_update_neuron": "",
    "latency_update_neuron": "",
    "energy_spike_out": "",
    "latency_spike_out": "",
    "energy_process_spike": "",
    "latency_process_spike": "",
    "energy_update": "",
    "latency_update": "",
    "energy_message_out": "",
    "latency_message_out": "",
    "connections_out": "(int) Connections outgoing from a neuron (deprecated)",
}

LOIHI_LIF_ATTRIBUTES = {
    "bias": "Bias current applied every step",
    "force_update": "(bool) Force soma to update every step.",
    "force_update_every_timestep": "(bool) Force soma to update every step.",
    "force_potential": "",
    "leak_decay": "(float) Multiplicative decay applied every step",
    "input_decay": "(float) Multiplicative decay applied to the input "
    "current every step",
    "log_u": "(bool) Record input current (u) for Loihi soma.",
    "noise": "(str) Noise source (file-based noise stream).",
    "noise_bits": "(int) The number of noise bits simulated.",
    "refractory_delay": "(int) Refractory steps after a spike, default=0.",
    "reset_mode": "(str) [none/soft/hard/saturate]. Default=hard",
    "reverse_reset_mode": "(str) [none/soft/hard/saturate]. Default=none",
    "reset": "(float) Reset potential. Default=0.0",
    "reverse_reset": "(float) Reverse reset potential.",
    "reverse_threshold": "(float) Reverse firing threshold.",
    "threshold": "(float) Firing threshold.",
    "potential": "(float) Initial potential.",
}

TRUENORTH_ATTRIBUTES = {
    "bias": "",
    "leak": "(float) Additive leak applied every step.",
    "leak_towards_zero": "(bool) Leak toward zero instead of additive.",
    "random_mask": "(int) Positive mask applied to LFSR noise.",
    "force_update": "",
    "force_update_every_timestep": "",
    "reset_mode": "",
    "reverse_reset_mode": "",
    "reset": "",
    "reverse_reset": "",
    "reverse_threshold": "",
    "threshold": "",
}

INPUT_ATTRIBUTES = {
    "rate": "(float) Rate-based input encoding.",
    "poisson": "(float) Poisson spike probability per step.",
    "spikes": "(list[bool]) A per-time-step spike train.",
}

MULTITAP_ATTRIBUTES = {
    "taps": "(int) Number of dendritic taps.",
    "time_constants": "(list[float]) RC time constants, one per tap.",
    "space_constants": "(list[float]) RC space constants, N-1 total.",
}

CURRENT_BASED_ATTRIBUTES = {
    "w": "(float) Synaptic weight",
    "weight": "(float) Synaptic weight",
}

_REGISTRY: dict[str, ModelSpec] = {}
_next_plugin_id = SOMA_MODEL_PLUGIN_BASE


def register_model(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise ValueError(f"Pipeline model not supported ({name})")
    return _REGISTRY[name]


def register_soma_model(
    name: str,
    update: Callable,
    params: dict[str, float] | None = None,
    state: dict[str, float] | None = None,
    attributes: dict[str, str] | None = None,
    dendrite_compartments: int = 0,
    shared_unit_state: bool = False,
    feed: Optional[Callable] = None,
) -> ModelSpec:
    """Register a Python soma model (the dlopen-plugin replacement).

    ``update(params, state, valid, current, t)`` receives dicts of [N]
    torch tensors of the chip's device and dtype (``valid`` bool,
    ``current`` the dtype, ``t`` the 1-based timestep as a 0-d int64
    tensor on the device) and must return ``(new_state, fired, updated,
    potential)``. On the card the step scan replays captured CUDA graphs
    (``ops/scan.py``), so the update runs device ops only: it reads no
    value back to the host and makes no host decision from its inputs.
    A model with ``dendrite_compartments > 0`` also receives ``comp``
    [N, K], the per-compartment input sums of the previous step. Under a
    ``ParameterSweep`` the tensors carry a leading sample axis ([B, N],
    ``comp`` [B, N, K]; a parameter may stay [N]), so an update written
    elementwise, indexing the last axes, serves both.

    Host work an update needs each step goes in ``feed(params, t0, length,
    lanes)``: called on the host once a chunk of ``length`` steps from step
    ``t0`` with the update's ``params`` and ``lanes``, the ``range`` of the
    chip's neuron indices its tensors hold, it returns a ``[length,
    len(lanes)]`` array (or None); the update then receives the keyword
    ``feed``, its step's row on the chip's device and dtype (None where the
    function returned None). When ``sim(mesh=...)`` shards the chip, each
    rank's update sees only the neurons that rank owns (the tensors are
    ``[N_rank]``, a slice of the padded chip, and ``lanes`` is that
    slice's range), so a feed that draws random numbers per neuron keys
    each draw by its index, and a sharded run draws what one device
    draws: NeuroFEM draws its noise so. Reuses the existing id if the name
    was registered before.
    """
    global _next_plugin_id
    existing = _REGISTRY.get(name)
    model_id = (
        existing.soma_model_id if existing is not None else _next_plugin_id
    )
    if existing is None:
        _next_plugin_id += 1
    spec = ModelSpec(
        name=name,
        implements_soma=True,
        implements_dendrite=dendrite_compartments > 0,
        attributes=attributes or {},
        soma_model_id=model_id,
        dendrite_model_id=(
            DENDRITE_MODEL_PLUGIN_COMP if dendrite_compartments > 0 else -1
        ),
        soma_update=update,
        param_defaults=dict(params or {}),
        state_init=dict(state or {}),
        dendrite_compartments=dendrite_compartments,
        shared_unit_state=shared_unit_state,
        feed=feed,
    )
    register_model(spec)
    return spec


def get_builtin_models() -> dict[str, dict[str, str]]:
    """Introspectable model catalog (src/models.cpp:969-987)."""
    return {name: dict(spec.attributes) for name, spec in _REGISTRY.items()}


register_model(
    ModelSpec(
        name="current_based",
        implements_synapse=True,
        attributes=CURRENT_BASED_ATTRIBUTES,
        synapse_model_id=SYNAPSE_MODEL_CURRENT_BASED,
    )
)
register_model(
    ModelSpec(
        name="accumulator",
        implements_dendrite=True,
        attributes={},
        dendrite_model_id=DENDRITE_MODEL_ACCUMULATOR,
    )
)
register_model(
    ModelSpec(
        name="accumulator_with_delay",
        implements_dendrite=True,
        attributes={"delay": "", "d": ""},
        dendrite_model_id=DENDRITE_MODEL_ACCUMULATOR_DELAY,
    )
)
register_model(
    ModelSpec(
        name="taps",
        implements_dendrite=True,
        attributes=MULTITAP_ATTRIBUTES,
        dendrite_model_id=DENDRITE_MODEL_MULTITAP,
    )
)
register_model(
    ModelSpec(
        name="input",
        implements_soma=True,
        attributes=INPUT_ATTRIBUTES,
        soma_model_id=SOMA_MODEL_INPUT,
    )
)
register_model(
    ModelSpec(
        name="leaky_integrate_fire",
        implements_soma=True,
        attributes=LOIHI_LIF_ATTRIBUTES,
        soma_model_id=SOMA_MODEL_LIF,
    )
)
register_model(
    ModelSpec(
        name="truenorth",
        implements_soma=True,
        attributes=TRUENORTH_ATTRIBUTES,
        soma_model_id=SOMA_MODEL_TRUENORTH,
    )
)

# Built-in Python plugin models (ports of the reference's dlopen examples)
from . import hodgkin_huxley  # noqa: E402,F401
from . import neurofem  # noqa: E402,F401
