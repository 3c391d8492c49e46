"""sanafe_tpu_torch: SANA-FE on PyTorch and CUDA.

The port of ``sanafe_tpu`` (JAX, written for a TPU) to PyTorch on an NVIDIA
H100. It imports ``torch`` and never ``jax`` or ``sanafe_tpu``: the JAX-free
host modules (builder API, compiler, trace writers, timing replica, native
scheduler bindings) are carried as copies, and the device path is the
whole-chunk engine of ``ops/chunk.py`` with its hand-written Hopper kernel
``csrc/chunk_kernel.cu``.

The same builder API and ``SpikingChip.load()/sim()`` surface as
``sanafe_tpu``; the YAML and netlist front-ends are not ported yet.
"""

from ._examples import load_example, load_loihi, load_truenorth
from .arch import Architecture
from .attributes import Attribute
from .chip import RunData, SpikingChip
from .network import NeuronConfiguration, SpikingNetwork
from .network import SpikingNetwork as Network

__all__ = [
    "Architecture",
    "Attribute",
    "Network",
    "NeuronConfiguration",
    "RunData",
    "SpikingChip",
    "SpikingNetwork",
    "load_example",
    "load_loihi",
    "load_truenorth",
]
