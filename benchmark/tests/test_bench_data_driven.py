"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries of BENCHMARK.json, with no edit to a file that is
there: a throwaway cell runs from a copy of the benchmark. So is a
configuration that brings its own plain reference and soma units."""

import json
import os
import shutil
import time

import pytest
import torch

from benchmark.harness import network, report, runner, spec
from benchmark.reference import chip, noc

from benchmark.harness.spec import BENCH_DIR, ROOT

CONFIG = '''"""A throwaway chain: group a drives group b, one core each."""
import numpy as np


def describe(cfg, seed):
    n = cfg["n"]
    rng = np.random.default_rng(seed)
    return {
        "name": cfg["name"], "arch": cfg["arch"], "dtype": cfg["dtype"],
        "groups": [
            {"name": "a", "n": n, "attributes": {"threshold": 1.0,
                                                 "bias": 2.0},
             "cores": np.zeros(n, dtype=int)},
            {"name": "b", "n": n, "attributes": {"threshold": 3.0},
             "cores": np.ones(n, dtype=int)}],
        "neuron_attributes": [],
        "edges": [{"kind": "dense", "src": "a", "dst": "b",
                   "weight": rng.random((n, n))}],
    }
'''

METRIC = '''"""Calls in the window (a throwaway per-layer metric)."""


def read(run):
    return float(len(run["calls"]))
'''


def copy_benchmark(tmp_path):
    """A copy of the benchmark under ``tmp_path``, the bytes of every file
    as copied, and BENCHMARK.json as a dict."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return tmp_path / "benchmark", before, bench


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    import sanafe_tpu_torch as st

    seen, sim = [], st.SpikingChip.sim

    def spy(chip, steps, **kwargs):
        seen.append(kwargs)
        return sim(chip, steps, **kwargs)

    monkeypatch.setattr(st.SpikingChip, "sim", spy)
    monkeypatch.setenv("SANAFE_BENCH_TEST_ENV", "0")
    b, before, bench = copy_benchmark(tmp_path)
    (b / "configs" / "tiny_chain.json").write_text(json.dumps(
        {"name": "tiny_chain", "arch": "loihi_like", "dtype": "float32",
         "n": 16}))
    (b / "configs" / "tiny_chain.py").write_text(CONFIG)
    (b / "traffic" / "sim20_simple.json").write_text(json.dumps(
        {"entry": "sim", "steps": 20, "timing_model": "simple",
         "kwargs": {"chunk": 7}, "env": {"SANAFE_BENCH_TEST_ENV": "1"},
         "checked_calls": 2, "trace_calls": 2, "trace_checked_calls": 2}))
    (b / "metrics" / "calls_in_window.py").write_text(METRIC)
    (b / "limits" / "tiny.simple.json").write_text(json.dumps(
        {"counts": 0.0, "energy": 1e-5, "sim_time": 1e-6}))
    bench["configs"].append({
        "name": "tiny_chain", "source": "a throwaway", "reduced": [],
        "file": "benchmark/configs/tiny_chain.json", "why": "a test"})
    bench["workloads"].append({
        "name": "tiny.simple", "config": "tiny_chain",
        "traffic": "sim20_simple", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "chip", "moves": "steps_per_s",
        "workloads": ["tiny.simple"]})
    # a part of a metric that has a reader: no file of its own
    bench["per_layer"].append({
        "name": "device.idle_pct.tiny", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "steps_per_s",
        "workloads": ["tiny.simple"]})
    for metric in bench["end_to_end"]:
        if "workloads" in metric and metric["name"] in ("steps_per_s",
                                                         "call_ms_p99"):
            metric["workloads"].append("tiny.simple")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():
        assert path.read_bytes() == data

    cell = spec.Cell(spec.load_benchmark(tmp_path / "BENCHMARK.json"),
                     "tiny.simple", bench_dir=b)
    for trace in (False, True):
        run = runner.run_cell(cell, 5, 0.1, trace, "cpu", time.perf_counter(),
                              log=lambda text: None)
        line = report.result_line(cell, run, trace)
        assert line["correct"], line["checks"]
        names = set(line["metrics"])
        # device.idle_pct.tiny is read by device.idle_pct.py, which finds
        # no device time on the CPU
        assert names == ({"calls_in_window", "setup.build_s"} if
                         trace else {"setup_s", "steps_per_s",
                                     "call_ms_p99"})
    assert cell.metric_reader({"name": "device.idle_pct.tiny"}).__file__ \
        .endswith("device.idle_pct.py")
    # the traffic's keyword arguments reach every sim() unchanged, and its
    # environment is set for the program
    assert seen and all(kw.get("chunk") == 7 for kw in seen)
    assert os.environ["SANAFE_BENCH_TEST_ENV"] == "1"


TWO_SOMAS = '''"""A throwaway chain on cores of two soma units: group a's
neurons dealt over both, one name a neuron; group b's all on the second."""
import numpy as np


def describe(cfg, seed):
    n = cfg["n"]
    rng = np.random.default_rng(seed)
    return {
        "name": cfg["name"], "arch": cfg["arch"], "dtype": cfg["dtype"],
        "groups": [
            {"name": "a", "n": n, "attributes": {"threshold": 1.0,
                                                 "bias": 2.0},
             "cores": np.arange(n) % 2,
             "soma_unit": np.where(np.arange(n) % 3, "soma_x", "soma_y")},
            {"name": "b", "n": n, "attributes": {"threshold": 3.0},
             "cores": np.ones(n, dtype=int), "soma_unit": "soma_y"}],
        "neuron_attributes": [],
        "edges": [{"kind": "dense", "src": "a", "dst": "b",
                   "weight": rng.random((n, n))}],
    }
'''

# a reference module of its own: reference/chip.py's, whose soma costs
# follow each neuron's unit, with the soma's update energy scaled
REFERENCE = '''"""A throwaway reference: the LIF chip's, its somas' update energy
scaled by {scale}."""
from benchmark.reference import chip
from benchmark.reference.chip import STATE_KEYS, from_program  # noqa: F401

Layout = chip.Layout


class Reference(chip.Reference):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.update_energy = {scale} * self.update_energy
'''


@pytest.mark.parametrize("case", ("copy", "planted", "units"))
def test_a_configuration_brings_its_reference_and_soma_units(
        tmp_path, monkeypatch, case):
    """A configuration whose JSON names a new module under reference/ and
    whose arch gives each core two soma units runs from new files alone:
    the module, built on reference/chip.py, passes; the same with a soma
    energy doubled fails (so the run used the module named); the chip's
    neurons sit on the units that the description named."""
    import sanafe_tpu_torch as st

    chips, load = [], st.SpikingChip.load

    def spy(program, net, *args, **kwargs):
        chips.append(program)
        return load(program, net, *args, **kwargs)

    monkeypatch.setattr(st.SpikingChip, "load", spy)
    b, before, bench = copy_benchmark(tmp_path)
    # the harness and the references read the copy's arch files
    for reader in (network, chip, noc):
        monkeypatch.setattr(reader, "DATA", b / "data")
    module = "chip_planted" if case == "planted" else "chip_units"
    (b / "reference" / f"{module}.py").write_text(
        REFERENCE.format(scale=2 if case == "planted" else 1))
    arch = json.loads((b / "data" / "loihi_like.json").read_text())
    x = dict(arch["core"]["soma"], name="soma_x")
    y = dict(arch["core"]["soma"], name="soma_y", attributes={
        k: 3 * v for k, v in arch["core"]["soma"]["attributes"].items()})
    arch["core"]["soma"] = [x, y]
    (b / "data" / "loihi_two_somas.json").write_text(json.dumps(arch))
    (b / "configs" / "two_somas.json").write_text(json.dumps(
        {"name": "two_somas", "arch": "loihi_two_somas", "dtype": "float32",
         "reference": module, "n": 12}))
    (b / "configs" / "two_somas.py").write_text(TWO_SOMAS)
    (b / "traffic" / "sim20_simple.json").write_text(json.dumps(
        {"entry": "sim", "steps": 20, "timing_model": "simple",
         "checked_calls": 2}))
    (b / "limits" / "somas.simple.json").write_text(json.dumps(
        {"counts": 0.0, "energy": 1e-5, "sim_time": 1e-6}))
    bench["configs"].append({
        "name": "two_somas", "source": "a throwaway", "reduced": [],
        "file": "benchmark/configs/two_somas.json", "why": "a test"})
    bench["workloads"].append({
        "name": "somas.simple", "config": "two_somas",
        "traffic": "sim20_simple", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():
        assert path.read_bytes() == data

    cell = spec.Cell(spec.load_benchmark(tmp_path / "BENCHMARK.json"),
                     "somas.simple", bench_dir=b)
    assert cell.reference.__file__ == str(b / "reference" / f"{module}.py")
    run = runner.run_cell(cell, 5, 0.1, False, "cpu", time.perf_counter(),
                          log=lambda text: None)
    line = report.result_line(cell, run, False)
    if case == "planted":
        assert not line["correct"], line["checks"]
        assert line["checks"]["energy"]["value"] > 1e-2, line["checks"]
        return
    assert line["correct"], line["checks"]
    if case == "units":
        desc = cell.describe(5)
        named = {("a", i): unit for i, unit in
                 enumerate(desc["groups"][0]["soma_unit"].tolist())}
        named.update({("b", i): "soma_y" for i in range(12)})
        (loaded,) = chips
        placed = {(r.group_name, r.offset): r.soma_unit.name
                  for r in loaded.compiled.neurons}
        assert placed == named
        assert {"soma_x", "soma_y"} == set(placed.values())


# runner.SimCalls.start_of before the reference module owned the casts
def start_of_before(rec, order, device, dtype) -> dict:
    state = {}
    for key, value in rec["start"].items():
        host = value.cpu()
        out = torch.empty_like(host)
        out[order] = host
        state[key] = out[None].to(device)
    state["refractory"] = state["refractory"].long()
    for key in ("potential", "input_current", "buffer_current"):
        state[key] = state[key].to(torch.float64).to(dtype)
    return state


def test_accepted_configurations_take_the_lif_reference(small_cell, bench):
    """Every accepted configuration resolves to reference/chip.py, and the
    program's state reaches the reference through its from_program as it
    did through the runner's own casts, dtypes included."""
    import sanafe_tpu_torch as st

    for config in {w["config"]: w["name"] for w in bench["workloads"]} \
            .values():
        assert spec.Cell(bench, config).reference.__file__ == str(
            BENCH_DIR / "reference" / "chip.py")
    torch.set_num_threads(2)
    cell = small_cell("full.simple")
    desc = cell.describe(9)
    arch, net = network.build_network(st, desc)
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float32)
    chip.load(net)
    calls = runner.SimCalls(chip, cell.traffic, cell.reference)
    chip.sim(7, timing_model="simple", heartbeat=0)
    rec = {"start": calls.snapshot()}
    layout = cell.reference.Layout(desc)
    calls.release(layout)
    ref = cell.reference.Reference(layout, "cpu", torch.float64)
    for dtype in (torch.float64, torch.float32):
        got = calls.start_of(rec, ref, "cpu", dtype)
        want = start_of_before(rec, calls.order, "cpu", dtype)
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key


def test_a_sampled_state_is_a_host_copy(small_cell):
    """The window's samples of the program's state sit on the host, apart
    from the program's: how many are held at once depends on the calls the
    seed draws, and on the card they would add that to peak_device_mib."""
    import sanafe_tpu_torch as st

    torch.set_num_threads(2)
    cell = small_cell("full.simple")
    arch, net = network.build_network(st, cell.describe(4))
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float32)
    chip.load(net)
    calls = runner.SimCalls(chip, cell.traffic, cell.reference)
    assert calls.snapshot() is None
    chip.sim(5, timing_model="simple", heartbeat=0)
    start = calls.snapshot()
    kept = {key: value.clone() for key, value in start.items()}
    chip.sim(5, timing_model="simple", heartbeat=0)
    assert list(start) == list(cell.reference.STATE_KEYS)
    for key, value in start.items():
        assert value.device.type == "cpu", key
        assert value.data_ptr() != chip._device_state[key].data_ptr(), key
        assert torch.equal(value, kept[key]), key
