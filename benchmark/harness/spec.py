"""``BENCHMARK.json`` and the files it names: each configuration, traffic
mix and per-layer metric sits in a file of its own, found by name."""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
DATA = BENCH_DIR / "data"


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """Import one file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration (the JSON
    of sizes and the module that describes it from a seed), its traffic mix
    and its metrics."""

    def __init__(self, bench: dict, name: str, bench_dir: Path = BENCH_DIR):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {', '.join(sorted(by_name))}")
        workload = by_name[name]
        self.name = name
        self.chips = int(workload["chips"])
        config = {c["name"]: c for c in bench["configs"]}[workload["config"]]
        self.config = json.loads((bench_dir.parent / config["file"])
                                 .read_text())
        self.config_module = load_module(
            bench_dir / "configs" / f"{config['name']}.py",
            f"bench_config_{config['name']}")
        traffic = bench_dir / "traffic" / f"{workload['traffic']}.json"
        self.traffic = json.loads(traffic.read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.bench_dir = bench_dir

    def metric_reader(self, metric: dict):
        """The reader of ``metric``: ``metrics/<name>.py``, else the file
        of the name with its last ``.<part>`` taken off, and so on
        (``device.idle_pct.sweep`` is read by ``device.idle_pct.py``
        where it has no file of its own)."""
        name = metric["name"]
        stem = name
        while not (self.bench_dir / "metrics" / f"{stem}.py").is_file():
            if "." not in stem:
                raise FileNotFoundError(f"no reader for metric {name!r}")
            stem = stem.rsplit(".", 1)[0]
        return load_module(self.bench_dir / "metrics" / f"{stem}.py",
                           "bench_metric_" + stem.replace(".", "_"))

    def describe(self, seed: int) -> dict:
        return self.config_module.describe(self.config, seed)
