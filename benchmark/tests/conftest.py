"""Fixtures of the benchmark's own tests. Run them from the repository's
root with ``python -m pytest benchmark/tests -q``; the card's tests with
``-m cuda`` on a machine with a CUDA device (they skip elsewhere)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def small_cell():
    """A cell of BENCHMARK.json with the TCAD'25 network cut to 8 cores of
    64 neurons, a size the CPU runs in a second."""
    from benchmark.harness import spec

    def make(name: str = "full.simple"):
        cell = spec.Cell(spec.load_benchmark(), name)
        if cell.config["name"] == "tcad25_full":
            cell.config = dict(cell.config, cores=8, neurons_per_core=64)
        return cell

    return make


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
