"""The step scan and the DAG engine on the card against the CPU, and the
level kernel against its plain version.

Chips whose dendrites keep per-edge state (delay rings, multitap cables)
take the scan's per-edge scatter, whose float sums must add in the same
order on both devices: the fired masks, the spike raster, the detailed
``sim_time`` and every logged potential are equal, in float64 and float32
alike. Energies come from reductions and matmuls that the card orders
otherwise: within 1e-12 relative in float64. A float32 sum of a few
thousand terms is itself about 1e-6 off, so in float32 both devices are
held to a float64 run: the card may add at most 1e-6 relative error
beyond the CPU's.

The DAG engine (``ops/dag_chunk.py``) runs the DVS-gesture net on the card
with the same spike raster and counters as on the CPU; its level kernel
(``csrc/level_kernel.cu``) equals ``level_plain`` bit for bit on the same
card tensors.

Card only (``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest``); the tests skip where there is no card.
"""

import numpy as np
import pytest
import torch

import sanafe_tpu_torch as st

from test_torch_chips import delay_chip, dvs_chip, multitap_chip, random_chip

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


@pytest.mark.cuda
def test_float32_energies_of_a_long_chunk(cuda):
    """The scan's batched roll-up over a 1024-step chunk keeps each step's
    float32 energies within 1e-6 relative of a float64 run (a float32 GEMM
    of that shape put the soma energy up to 1.6e-5 off; the product now
    runs in float64 and rounds once)."""
    runs = []
    for dtype in (torch.float32, torch.float64):
        arch, net = random_chip(st, cores=32, neurons_per_core=128,
                                n_log_potential=0)
        chip = st.SpikingChip(arch, device=cuda, dtype=dtype)
        chip.load(net)
        runs.append(chip.sim(1024, timing_model="simple", heartbeat=0,
                             perf_trace=True, chunk=1024))
    a, b = (r["perf_trace"] for r in runs)
    assert a["fired"] == b["fired"]
    for key in ("synapse_energy", "soma_energy", "network_energy",
                "total_energy"):
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert np.all(np.abs(x - y) <= 1e-6 * np.abs(y)), key


def _bits(x):
    """A tensor's bit pattern (so that -0.0 and 0.0 differ)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def _assert_level_equal(a, b, what):
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            assert x is None and y is None, (what, field)
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (what, field)
        assert torch.equal(_bits(x), _bits(y)), (what, field)


def _capture_levels(chip_args, steps, device):
    """The level kernel's arguments of each level of the first DAG chunk of
    a ``steps``-step run (the inputs the DAG engine really gives it)."""
    from sanafe_tpu_torch.ops import dag_chunk

    calls = []
    real = dag_chunk.level_kernel

    def capture(*args):
        calls.append(args)
        return real(*args)

    dag_chunk.level_kernel = capture
    try:
        chip = st.SpikingChip(chip_args[0], device=device)
        chip.load(chip_args[1])
        result = chip.sim(steps, timing_model="simple", heartbeat=0,
                          potential_trace=True, neuron_trace=True)
    finally:
        dag_chunk.level_kernel = real
    assert result["device_engine"] == "dag"
    return calls


def _random_level(device, size=1500, steps=300, seed=3):
    """A LIF level whose lanes draw every option: hard, soft and no reset,
    reverse soft/hard/saturate resets, refractory delays up to 3, forced
    updates, leaks, biases, a noise plane, and a non-zero start state;
    currents and noise off the 1/64 grid."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(device)
    u = lambda n=size: torch.from_numpy(  # noqa: E731
        rng.random(n).astype(np.float32)).to(device)
    i = lambda hi, n=size: torch.from_numpy(  # noqa: E731
        rng.integers(0, hi, n).astype(np.int32)).to(device)
    params = {
        "bias": f(size) * (u() < 0.5),
        "leak_decay": u(),
        "input_decay": u(),
        "threshold": f(size).abs() + 0.5,
        "reverse_threshold": -f(size).abs() - 0.5,
        "reset": f(size) * 0.1,
        "reverse_reset": -f(size).abs() * 0.1,
        "refractory_delay": i(4),
        "reset_mode": i(3),
        "reverse_reset_mode": i(4),
        "force_update": i(2) > 0,
    }
    r0 = i(3)
    return (params, f(size), f(size) * 0.1, r0, f(steps, size),
            torch.from_numpy(rng.random((steps, size)) < 0.3).to(device),
            f(steps, size) * 0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dvs", "random"])
def test_level_kernel_matches_plain(cuda, case):
    """``level_kernel`` equals ``level_plain`` on the same card tensors bit
    for bit (fired, updated, v and u after every step, the final state):
    on every level of the DVS net's first 1024-step chunk, as the DAG
    engine gives them; and on a random LIF level with noise, every reset
    mode and refractory delays, from step 1 (no leak) and from step 40,
    with and without the v and u planes."""
    from sanafe_tpu_torch.ops.level_scan import level_kernel, level_plain

    if case == "dvs":
        calls = _capture_levels(dvs_chip(st, log_spikes=False), 1024, cuda)
        assert len(calls) == 6  # input, conv2d_0..3, dense_0: all LIF
    else:
        args = _random_level(cuda)
        calls = [args + (t0, rv, ru) for t0 in (1, 40)
                 for rv, ru in ((True, True), (False, False))]
    before = level_kernel.launches
    for args in calls:
        got = level_kernel(*args)
        want = level_plain(*args)
        torch.cuda.synchronize()
        _assert_level_equal(want, got, case)
        assert bool(got.fired.any()) and bool(got.updated.any())
    assert level_kernel.launches == before + len(calls)


@pytest.mark.cuda
def test_dvs_dag_on_cuda_matches_cpu(cuda, tmp_path):
    """The DVS-gesture net through the DAG engine on the card: 200 steps
    with the spike trace give the CPU run's spikes.csv bytes and counters,
    and the level kernel ran."""
    from sanafe_tpu_torch.ops.level_scan import level_kernel

    runs = []
    for device in (cuda, "cpu"):
        arch, net = dvs_chip(st)
        chip = st.SpikingChip(arch, device=device)
        chip.load(net)
        path = tmp_path / f"{torch.device(device).type}.csv"
        before = level_kernel.launches
        result = chip.sim(200, timing_model="simple", heartbeat=0,
                          spike_trace=path)
        chip.close()
        result["launches"] = level_kernel.launches - before
        result["csv"] = path.read_bytes()
        runs.append(result)
    a, b = runs
    assert a["device_engine"] == b["device_engine"] == "dag"
    assert a["launches"] > 0
    assert a["csv"] == b["csv"]
    for key in ("spikes", "neurons_fired", "neurons_updated", "packets_sent"):
        assert a[key] == b[key], key
    for key, value in b["energy"].items():
        assert abs(a["energy"][key] - value) <= 1e-6 * abs(value), key
