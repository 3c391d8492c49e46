"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries of BENCHMARK.json, with no edit to a file that is
there: a throwaway cell runs from a copy of the benchmark."""

import json
import os
import shutil
import time

from benchmark.harness import report, runner, spec

from benchmark.harness.spec import ROOT

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


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    import sanafe_tpu_torch as st

    seen, sim = [], st.SpikingChip.sim

    def spy(chip, steps, **kwargs):
        seen.append(kwargs)
        return sim(chip, steps, **kwargs)

    monkeypatch.setattr(st.SpikingChip, "sim", spy)
    monkeypatch.setenv("SANAFE_BENCH_TEST_ENV", "0")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = tmp_path / "benchmark"
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
