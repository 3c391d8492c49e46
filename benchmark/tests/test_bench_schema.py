"""BENCHMARK.json against the files it names and the contract's shape."""

import re

from benchmark.harness import spec

from benchmark.harness.spec import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_has_its_files(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    b = ROOT / "benchmark"
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert (b / "configs" / f"{c['name']}.py").is_file()
        assert c["reduced"] == []
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert (b / "traffic" / f"{w['traffic']}.json").is_file()
        assert (b / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert spec.Cell(bench, bench["workloads"][0]["name"]) \
            .metric_reader(m).read
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_its_layers_move(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_metric_with_no_file_of_its_own_is_read_by_its_stem(bench):
    cell = spec.Cell(bench, "full.sweep16")
    idle = cell.metric_reader({"name": "device.idle_pct.sweep"})
    assert idle.__file__.endswith("metrics/device.idle_pct.py")
    rate = cell.metric_reader({"name": "steps_per_s.detailed"})
    assert rate.__file__.endswith("metrics/steps_per_s.py")
    try:
        cell.metric_reader({"name": "no_such.metric"})
    except FileNotFoundError:
        pass
    else:
        raise AssertionError("a metric with no reader was found")
