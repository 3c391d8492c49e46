"""The result line: the cell's metrics by their readers, the device, the
trace's breakdown, and last the numbers compared with their limits."""

import torch

from . import judge


def result_line(cell, run: dict, trace: bool) -> dict:
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = cell.metric_reader(metric).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    correct, checks = judge.verdict(run["found"],
                                    judge.load_limits(cell.name,
                                                      cell.bench_dir))
    device = run["device"]
    on_card = device.type == "cuda"
    info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": run["peak_bytes"],
    }
    line = {"correct": correct, "attempted": run["attempted"],
            "failed": run["failed"], "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = run["trace"]["busy_s"]
        info["window_s"] = run["trace"]["window_s"]
        line["breakdown"] = run["trace"]["breakdown"]
    line["checks"] = checks
    return line


def check_lines(line: dict) -> list:
    return [f"check {key}: {c['value']!r} (limit {c['limit']!r})"
            for key, c in line["checks"].items()]
