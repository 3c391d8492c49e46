"""The harness refuses to run without the CUDA devices a cell asks for,
and without the program: it prints no result and exits non-zero."""

import os
import shutil
import subprocess
import sys

from benchmark.harness.spec import ROOT


def run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "full.simple",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_no_card_no_result():
    out = run(ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
