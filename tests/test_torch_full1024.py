"""The benchmark's ``tcad25_full1024`` configuration (TCAD'25's largest
random network, ``benchmark/configs/tcad25_full1024.py``) at a small size.

- The generator's draws: exactly the driven share, distinct destination
  cores a driven neuron and distinct neurons a message, the edge count the
  sizes give, the same edges for the same seed (a seed past 32 bits too)
  and other edges for another; its bounded draw (``distinct_draws``)
  uniform over the values.
- The cell ``full1024.simple`` at 8 cores of 64 neurons with 4 messages of
  4 spikes, run by the benchmark's runner through ``SpikingChip.sim`` on
  the CPU, the step scan's default program and a program that delivers
  through the kernel's path (the live rows alone), against the plain
  reference (``benchmark/reference/chip.py``) from seeded draws: counts
  exact, every energy within 1e-5 relative and ``sim_time`` within the
  cell's limit (``benchmark/limits/full1024.simple.json``)."""

import functools
import json
import time

import numpy as np
import pytest

from benchmark.harness import report, runner, spec
from sanafe_tpu_torch import chip as port_chip
from sanafe_tpu_torch.ops import step as port_step

CUT = dict(cores=8, neurons_per_core=64, messages_per_neuron=4,
           spikes_per_message=4)


def config(**cut) -> tuple:
    cfg = json.loads((spec.BENCH_DIR / "configs"
                      / "tcad25_full1024.json").read_text())
    module = spec.load_module(spec.BENCH_DIR / "configs"
                              / "tcad25_full1024.py", "test_full1024")
    return dict(cfg, **cut), module


def test_full1024_is_the_published_row():
    cfg, _ = config()
    assert (cfg["cores"], cfg["neurons_per_core"], cfg["messages_per_neuron"],
            cfg["spikes_per_message"], cfg["spike_percentage"]) == (
        128, 1024, 16, 16, 50)
    assert cfg["reduced"] == []
    arch = json.loads((spec.BENCH_DIR / "data" / "loihi_like.json")
                      .read_text())
    assert arch["tiles"] * arch["cores_per_tile"] == cfg["cores"]
    assert arch["core"]["max_neurons"] == cfg["neurons_per_core"]


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_full1024_draws(seed):
    cfg, module = config(**CUT)
    a = module.describe(cfg, seed)
    again = module.describe(cfg, seed)
    other = module.describe(cfg, seed + 1)
    n = 8 * 64
    (group,) = a["groups"]
    assert group["n"] == n
    np.testing.assert_array_equal(group["cores"], np.arange(n) // 64)
    driven = a["neuron_attributes"][0]["index"]
    assert len(driven) == n // 2 and len(set(driven.tolist())) == n // 2
    (e,) = a["edges"]
    assert len(e["src_idx"]) == len(e["dst_idx"]) == len(driven) * 16
    np.testing.assert_array_equal(e["src_idx"], np.repeat(driven, 16))
    per_src = e["dst_idx"].reshape(len(driven), 4, 4)
    cores = per_src // 64
    assert (cores == cores[:, :, :1]).all()  # a message goes to one core
    for row in cores[:, :, 0]:
        assert len(set(row.tolist())) == 4  # distinct cores a neuron
    for message in per_src.reshape(-1, 4):
        assert len(set(message.tolist())) == 4  # distinct neurons
    assert (e["weight"] == 128.0).all()
    for key in ("src_idx", "dst_idx"):
        np.testing.assert_array_equal(again["edges"][0][key], e[key])
    assert not np.array_equal(other["edges"][0]["dst_idx"], e["dst_idx"])


def test_distinct_draws_are_uniform_and_bounded():
    _, module = config()
    rng = np.random.default_rng(3)
    rows = module.BLOCK + 5000  # more than one block
    out = module.distinct_draws(rng, rows, 6, 16)
    assert out.shape == (rows, 6)
    ordered = np.sort(out, axis=1)
    assert (ordered[:, 1:] != ordered[:, :-1]).all()
    # every value as often in every place (6 / 16 of the rows each)
    counts = np.stack([np.bincount(out[:, k], minlength=16)
                       for k in range(6)])
    expect = rows / 16
    assert np.abs(counts - expect).max() < 6 * np.sqrt(expect)


@pytest.fixture(params=["default", "live_rows"])
def program(request, monkeypatch):
    """The CPU's default program, or one that delivers through the
    kernel's path (the live rows alone, summed in the kernel's order)."""
    if request.param == "live_rows":
        monkeypatch.setattr(port_chip, "make_device_program",
                            functools.partial(port_step.make_device_program,
                                              use_kernel=True))
    return request.param


@pytest.mark.parametrize("seed", [7, 2**31 + 101])
def test_full1024_cell_against_the_reference(program, seed):
    cell = spec.Cell(spec.load_benchmark(), "full1024.simple")
    cell.config = dict(cell.config, **CUT)
    cell.traffic = dict(cell.traffic, steps=20, checked_calls=2)
    run = runner.run_cell(cell, seed, 0.2, False, "cpu", time.perf_counter(),
                          log=lambda text: None)
    line = report.result_line(cell, run, False)
    assert line["correct"], line["checks"]
    checks = line["checks"]
    assert checks["counts"]["value"] == 0.0
    assert checks["energy"]["value"] <= 1e-5
    limits = json.loads((spec.BENCH_DIR / "limits"
                         / "full1024.simple.json").read_text())
    assert checks["sim_time"]["value"] <= limits["sim_time"]
    assert line["attempted"] >= 1
