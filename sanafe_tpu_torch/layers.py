"""Keras-style layer helpers for building deep SNNs.

Mirrors the reference's ``sanafe/layers.py``: ``Input2D`` / ``Conv2D`` /
``Dense`` wrap neuron-group creation plus the conv2d/dense hyperedge
connectors. Neuron indexing is channels-first flattened, weights are
WHCN-ordered 4D tensors for convolutions and (n_src, n_dest) matrices for
dense layers.
"""

from __future__ import annotations

import numpy as np

from .network import SpikingNetwork


class Layer:
    """Base layer: indexing/iteration delegate to the neuron group
    (reference sanafe/layers.py:23-84)."""

    def __init__(self):
        self.group = None

    def __getitem__(self, key):
        return self.group[key]

    def __len__(self):
        return len(self.group)

    def __iter__(self):
        for offset in range(len(self.group)):
            yield self.group[offset]


class Input2D(Layer):
    """2D input layer (flattened, channels-first) —
    reference sanafe/layers.py:86-145."""

    _count = 0

    def __init__(self, snn: SpikingNetwork, width: int, height: int,
                 channels: int = 1, **kwargs):
        super().__init__()
        if width <= 0 or height <= 0 or channels <= 0:
            raise ValueError("Width, height, and channels must be positive")
        self.width = width
        self.height = height
        self.channels = channels
        self.group = snn.create_neuron_group(
            f"input_{Input2D._count}",
            width * height * channels,
            model_attributes=kwargs,
        )
        Input2D._count += 1


class Conv2D(Layer):
    """2D convolutional layer; weights are (W, H, C_in, C_out) —
    reference sanafe/layers.py:147-260."""

    _count = 0

    def __init__(self, snn: SpikingNetwork, prev_layer: Layer,
                 weights: np.ndarray, stride_width: int = 1,
                 stride_height: int = 1, pad_width: int = 0,
                 pad_height: int = 0, **kwargs):
        super().__init__()
        weights = np.asarray(weights)
        if weights.ndim != 4:
            raise ValueError(
                "Expected weights kernel with 4 dimensions in the order "
                "'WHCN' (Width, Height, Channels_in, Channels_out)"
            )
        if stride_width <= 0 or stride_height <= 0:
            raise ValueError("Stride values must be positive")
        if pad_width < 0 or pad_height < 0:
            raise ValueError("Padding values cannot be negative")
        if pad_width or pad_height:
            raise ValueError(
                "Non-zero padding is not supported (the hardware conv2d "
                "lowering is zero-padding only; src/network.cpp:408-420)"
            )
        kernel_width, kernel_height, in_channels, filter_count = weights.shape
        if (
            hasattr(prev_layer, "channels")
            and prev_layer.channels != in_channels
        ):
            raise ValueError(
                f"Input channels mismatch: prev_layer has "
                f"{prev_layer.channels} channels but weights expect "
                f"{in_channels}"
            )
        self.width = 1 + (prev_layer.width - kernel_width) // stride_width
        self.height = 1 + (prev_layer.height - kernel_height) // stride_height
        self.channels = filter_count
        if self.width <= 0 or self.height <= 0:
            raise ValueError(
                f"Invalid output dimensions ({self.width}x{self.height}). "
                "Check kernel size, stride, and padding parameters."
            )
        self.group = snn.create_neuron_group(
            f"conv2d_{Conv2D._count}",
            self.width * self.height * self.channels,
            model_attributes=kwargs,
        )
        prev_layer.group.connect_neurons_conv2d(
            self.group,
            {"w": weights.flatten()},
            prev_layer.width,
            prev_layer.height,
            prev_layer.channels,
            kernel_width,
            kernel_height,
            filter_count,
            stride_width,
            stride_height,
        )
        Conv2D._count += 1


class Dense(Layer):
    """Fully-connected layer; weights are (n_src, n_dest) —
    reference sanafe/layers.py:262-324."""

    _count = 0

    def __init__(self, snn: SpikingNetwork, prev_layer: Layer,
                 neuron_count: int, weights: np.ndarray, **kwargs):
        super().__init__()
        if neuron_count <= 0:
            raise ValueError("Neuron count must be positive")
        weights = np.asarray(weights)
        expected_shape = (len(prev_layer), neuron_count)
        if weights.shape != expected_shape:
            raise ValueError(
                f"Weight matrix shape {weights.shape} doesn't match expected "
                f"shape {expected_shape} for connection from "
                f"{len(prev_layer)} to {neuron_count} neurons"
            )
        self.group = snn.create_neuron_group(
            f"dense_{Dense._count}",
            neuron_count,
            model_attributes=kwargs,
        )
        prev_layer.group.connect_neurons_dense(
            self.group, {"w": weights.flatten()}
        )
        Dense._count += 1
