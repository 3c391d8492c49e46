"""sanafe_tpu_torch: SANA-FE on PyTorch and CUDA.

The port of ``sanafe_tpu`` (JAX, written for a TPU) to PyTorch on an NVIDIA
H100. It imports ``torch`` and never ``jax`` or ``sanafe_tpu``: the JAX-free
host modules (builder API, compiler, trace writers, timing replica, native
scheduler bindings) are carried as copies, and the device path is the
whole-chunk engine of ``ops/chunk.py``, the step scan of ``ops/scan.py`` and
the feed-forward (DAG) engine of ``ops/dag_chunk.py``, with hand-written
Hopper kernels under ``csrc/``.

The same builder API, YAML and netlist front-ends (``load_arch``,
``load_net``, ``SpikingNetwork.save``; YAML needs PyYAML, imported when a
description is read), ``SpikingChip.load()/sim()``, runtime attribute
updates (``mapped_neuron_groups``), ``.npz`` checkpoints, Python plugin
soma models (``models.register_soma_model``, ``plugins.load_plugin``),
parameter sweeps (``ParameterSweep``), the trace converters (``data``),
plots (``viz``), the Lava and Fugu bridges (``lava``, ``fugu``) and the
command line (``python -m sanafe_tpu_torch.cli``) surface as
``sanafe_tpu``. pandas and matplotlib are imported when a converter or a
plot first runs, never by ``import sanafe_tpu_torch``.
"""

from ._examples import examples_dir, load_example, load_loihi, load_truenorth
from .arch import (
    Architecture,
    BufferPosition,
    CoreConfiguration,
    TileConfiguration,
    load_arch,
)
from .attributes import Attribute
from .chip import RunData, SpikingChip
from .compile import HardwareMappingError
from .models import ModelSpec, get_builtin_models, register_model
from .network import (
    Connection,
    Conv2DParameters,
    Neuron,
    NeuronConfiguration,
    NeuronGroup,
    SpikingNetwork,
    load_net,
)
from .network import SpikingNetwork as Network
from .trace import NeuronAddress
from .yaml_arch import DescriptionParsingError
from .batch import ParameterSweep, expand_group_values
from . import data, layers, plugins

__version__ = "0.1.0"

__all__ = [
    "Architecture",
    "Attribute",
    "ParameterSweep",
    "expand_group_values",
    "BufferPosition",
    "Connection",
    "Conv2DParameters",
    "CoreConfiguration",
    "DescriptionParsingError",
    "HardwareMappingError",
    "ModelSpec",
    "Network",
    "Neuron",
    "NeuronAddress",
    "NeuronConfiguration",
    "NeuronGroup",
    "RunData",
    "SpikingChip",
    "SpikingNetwork",
    "TileConfiguration",
    "examples_dir",
    "get_builtin_models",
    "load_arch",
    "load_example",
    "load_loihi",
    "load_net",
    "load_truenorth",
    "register_model",
]
