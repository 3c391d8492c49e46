"""The roofline byte counts on a hand-sized network: the work the inputs
need, counted from the description and the raster."""

import numpy as np
import pytest

from benchmark.harness import roofline, spec
from benchmark.harness.runner import Call
from benchmark.reference.chip import Layout

BW = roofline.HBM_BYTES_S
DELIVERY = "sanafe_tpu_torch.ops.delivery:delivery_kernel"
BATCH = "sanafe_tpu_torch.ops.delivery:delivery_batch_kernel"
LEVEL = "sanafe_tpu_torch.ops.level_scan:level_kernel"


def reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py",
                            f"test_metric_{name}")


def test_each_reader_names_a_launch_counter_of_the_program():
    import importlib

    for name, wrapper in (("delivery_kernel_roofline", DELIVERY),
                          ("delivery_batch_kernel_roofline", BATCH),
                          ("level_kernel_roofline", LEVEL)):
        assert reader(name).WRAPPER == wrapper
        module, function = wrapper.split(":")
        assert isinstance(getattr(importlib.import_module(module),
                                  function).launches, int)


def tiny():
    """Four neurons on two cores; edges 0->1, 0->2, 1->3."""
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


def trace(kernels: dict, launches: dict) -> dict:
    return {"busy_s": 1.0, "ops": kernels, "launches": launches}


def test_delivery_counts_fired_edges_plane_and_outputs():
    layout = Layout(tiny())
    assert layout.fanout.tolist() == [2, 1, 0, 0]
    fired = np.array([[1, 0, 0, 0], [1, 1, 0, 0]], dtype=bool)
    run = {"layout": layout, "rasters": [fired], "trace": trace(
        {"void (anonymous namespace)::live_kernel<float>(float const*)":
         (2e-6, 2)}, {DELIVERY: 2})}
    # 8 B an edge fired; the plane and the arrivals a bit a neuron, the
    # currents 4 B a neuron
    least = (8 * 2 + 0.5 + 16 + 0.5) / BW + (8 * 3 + 17) / BW
    assert reader("delivery_kernel_roofline").read(run) == pytest.approx(
        100 * least / 2e-6)


def test_a_kernel_the_profiler_lost_is_not_measured():
    layout = Layout(tiny())
    fired = np.ones((2, 4), dtype=bool)
    run = {"layout": layout, "rasters": [fired], "trace": trace(
        {"void live_kernel<float>()": (2e-6, 1)}, {DELIVERY: 2})}
    assert reader("delivery_kernel_roofline").read(run) is None
    run["trace"]["busy_s"] = 0.0
    assert reader("delivery_kernel_roofline").read(run) is None


def test_batched_delivery_reads_the_union_of_fired_edges_once():
    layout = Layout(tiny())
    fired = np.zeros((1, 2, 4), dtype=bool)
    fired[0, 0, 0] = True  # sample 0: neuron 0 (2 edges)
    fired[0, 1, 1] = True  # sample 1: neuron 1 (1 edge)
    run = {"layout": layout, "rasters": [fired], "trace": trace(
        {"void batch_kernel<float, 4>(float const*)": (3e-6, 1),
         "void mask_kernel<float>(float const*)": (1e-6, 1),
         "void delivery_batch_other(float)": (5e-6, 1)},
        {BATCH: 1})}
    least = (8 * 3 + 2 * 17) / BW
    assert reader("delivery_batch_kernel_roofline").read(run) == \
        pytest.approx(100 * least / 4e-6)


def test_level_kernel_counts_lane_steps_parameters_and_state():
    desc = tiny()
    desc["groups"] = [
        {"name": "a", "n": 3, "attributes": {}, "cores": np.zeros(3, int)},
        {"name": "b", "n": 5, "attributes": {}, "cores": np.ones(5, int)}]
    desc["edges"] = []
    run = {"desc": desc, "calls": [Call(0.0, 1.0, 10, 1)], "trace": trace(
        {"void (anonymous namespace)::level_kernel<false, false, false>()":
         (1e-6, 2)}, {LEVEL: 2})}
    least = sum(max((n * 10 * 4.125 + n * 52) / BW,
                    8 * n * 10 / roofline.F32_OPS_S) for n in (3, 5))
    assert reader("level_kernel_roofline").read(run) == pytest.approx(
        100 * least / 1e-6)
