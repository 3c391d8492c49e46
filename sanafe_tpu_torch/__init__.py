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
soma models (``models.register_soma_model``, ``plugins.load_plugin``) and
the command line (``python -m sanafe_tpu_torch.cli``) surface as
``sanafe_tpu``.
"""

from ._examples import examples_dir, load_example, load_loihi, load_truenorth
from .arch import Architecture, load_arch
from .attributes import Attribute
from .chip import RunData, SpikingChip
from .compile import HardwareMappingError
from .models import ModelSpec, get_builtin_models, register_model
from .network import NeuronConfiguration, SpikingNetwork, load_net
from .network import SpikingNetwork as Network
from .yaml_arch import DescriptionParsingError
from . import layers, plugins

__all__ = [
    "Architecture",
    "Attribute",
    "DescriptionParsingError",
    "HardwareMappingError",
    "ModelSpec",
    "Network",
    "NeuronConfiguration",
    "RunData",
    "SpikingChip",
    "SpikingNetwork",
    "examples_dir",
    "get_builtin_models",
    "load_arch",
    "load_example",
    "load_loihi",
    "load_net",
    "load_truenorth",
    "register_model",
]
