"""The step scan on the card against the CPU, through ``SpikingChip``.

Chips whose dendrites keep per-edge state (delay rings, multitap cables)
take the scan's per-edge scatter, whose float sums must add in the same
order on both devices: the fired masks, the spike raster, the detailed
``sim_time`` and every logged potential are equal, in float64 and float32
alike. Energies come from reductions and matmuls that the card orders
otherwise: within 1e-12 relative in float64. A float32 sum of a few
thousand terms is itself about 1e-6 off, so in float32 both devices are
held to a float64 run: the card may add at most 1e-6 relative error
beyond the CPU's.

Card only (``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest``); the tests skip where there is no card.
"""

import numpy as np
import pytest
import torch

import sanafe_tpu_torch as st

from test_torch_chips import delay_chip, multitap_chip

STEPS = 200
N = 2048  # enough fan-in that bins add several values each step


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("builder", [delay_chip, multitap_chip])
def test_scatter_scan_on_cuda_matches_cpu(cuda, builder, dtype):
    runs = []
    for device, run_dtype in ((cuda, dtype), ("cpu", dtype),
                              ("cpu", torch.float64)):
        arch, net = builder(st, n=N)
        chip = st.SpikingChip(arch, device=device, dtype=run_dtype)
        chip.load(net)
        runs.append(chip.sim(STEPS, timing_model="detailed", heartbeat=0,
                             spike_trace=True, potential_trace=True))
    a, b, wide = runs
    assert a["device_engine"] == b["device_engine"] == "scan"
    assert a["neurons_fired"] > 0
    for key in ("spikes", "neurons_fired", "neurons_updated", "packets_sent",
                "sim_time"):
        assert a[key] == b[key], key
    assert [[(x.group_name, x.neuron_offset) for x in step]
            for step in a["spike_trace"].data] == [
        [(x.group_name, x.neuron_offset) for x in step]
        for step in b["spike_trace"].data]
    np.testing.assert_array_equal(np.asarray(a["potential_trace"].data),
                                  np.asarray(b["potential_trace"].data))
    for key, ref in wide["energy"].items():
        x, y = a["energy"][key], b["energy"][key]
        if dtype == torch.float64:
            assert abs(x - y) <= 1e-12 * max(abs(y), 1e-30), key
        else:
            assert abs(x - ref) <= abs(y - ref) + 1e-6 * abs(ref), key
