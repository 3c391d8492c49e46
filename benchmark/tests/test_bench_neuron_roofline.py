"""The neuron kernel's roofline reader on a hand-sized network: the bytes
counted from the description and the raster, and the wrapper it names."""

import importlib

import numpy as np
import pytest

from benchmark.harness import roofline, spec
from benchmark.reference.chip import Layout

NEURON = "sanafe_tpu_torch.ops.neuron:neuron_kernel"


def reader():
    return spec.load_module(
        spec.BENCH_DIR / "metrics" / "neuron_kernel_roofline.py",
        "test_metric_neuron_kernel_roofline")


def tiny():
    """Four neurons on two cores; edges 0->1, 0->2 (one message each,
    to cores 0 and 1), 1->3."""
    return {
        "name": "tiny", "arch": "loihi_like", "dtype": "float32",
        "groups": [{"name": "a", "n": 4, "attributes": {"threshold": 1.0},
                    "cores": np.array([0, 0, 1, 1])}],
        "neuron_attributes": [],
        "edges": [{"kind": "sparse", "src": "a", "dst": "a",
                   "src_idx": np.array([0, 0, 1]),
                   "dst_idx": np.array([1, 2, 3]),
                   "weight": np.array([2.0, 2.0, 2.0])}],
    }


def test_reader_names_the_programs_launch_counter():
    assert reader().WRAPPER == NEURON
    module, function = NEURON.split(":")
    assert isinstance(getattr(importlib.import_module(module),
                              function).launches, int)


def test_neuron_kernel_counts_state_flags_and_fired_messages():
    layout = Layout(tiny())
    assert layout.n_axons.tolist() == [2, 1, 0, 0]
    fired = np.array([[1, 0, 0, 0], [1, 1, 0, 1]], dtype=bool)
    run = {"layout": layout, "rasters": [fired], "trace": {
        "busy_s": 1.0, "launches": {NEURON: 2},
        "ops": {"(anonymous namespace)::neuron_kernel("
                "(anonymous namespace)::Args)": (2e-6, 2)}}}
    # 28 B and three bits a neuron, 4 B a fired message: 2, then 3
    least = (28 * 4 + 1.5 + 4 * 2) / roofline.HBM_BYTES_S \
        + (28 * 4 + 1.5 + 4 * 3) / roofline.HBM_BYTES_S
    assert reader().read(run) == pytest.approx(100 * least / 2e-6)
    run["trace"]["launches"] = {NEURON: 3}  # a launch the profiler lost
    assert reader().read(run) is None
