"""The port's command line (``python -m sanafe_tpu_torch.cli``) against
sanafe_tpu's (``sanafe_tpu.cli``), on the CPU.

- The reference binary's goldens through the port's CLI with
  ``SANAFE_TPU_CLI_EXACT=1`` (the CPU in float64): cfg5_hh (netlist,
  Hodgkin-Huxley plugin somas) and cfg_stochastic, run from the fixtures
  directory as ``tests/test_reference_parity.py`` runs them: the four CSVs
  byte for byte, ``run_summary.yaml`` equal but for the build id and the
  wall times.
- Flags parse as sanafe_tpu's parse them, and the trace wiring writes the
  same files (``-s`` drives the spike, potential, perf and message traces;
  ``SANAFE_TPU_SANE_TRACES=1`` gives each flag its own trace).
- Errors exit 1 with sanafe_tpu's message; without a card and without
  ``SANAFE_TPU_CLI_EXACT=1`` the port exits 1 with SpikingChip's "CUDA is
  not available" instead of moving to the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sanafe_tpu import cli as jax_cli
from sanafe_tpu_torch import cli

from test_torch_chips import summary_without_volatile

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden_ref"
FIXTURES = GOLDEN / "fixtures"
TRACES = ("spikes", "potentials", "perf", "messages")
# (golden, arch, snn, netlist?)
GOLDENS = {
    "cfg5_hh": ("arch_hh.yaml", "snn_hh.net", True),
    "cfg_stochastic": ("arch_stoch.yaml", "snn_stoch.yaml", False),
}


@pytest.fixture()
def exact(monkeypatch):
    monkeypatch.setenv("SANAFE_TPU_CLI_EXACT", "1")
    monkeypatch.delenv("SANAFE_TPU_SANE_TRACES", raising=False)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_reference_golden_through_cli(name, exact, tmp_path, monkeypatch,
                                      capsys):
    arch, snn, netlist = GOLDENS[name]
    monkeypatch.chdir(FIXTURES)  # the noise file is cwd-relative
    argv = ["-o", str(tmp_path), "-s"] + (["-n"] if netlist else []) + [
        "-t", "detailed", arch, snn, "100"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Run finished." in out and "***** Run Summary *****" in out
    for trace in TRACES:
        golden = (GOLDEN / name / f"{trace}.csv").read_text()
        assert (tmp_path / f"{trace}.csv").read_text() == golden, trace
    golden = (GOLDEN / name / "run_summary.yaml").read_text()
    assert summary_without_volatile(
        (tmp_path / "run_summary.yaml").read_text()) == (
        summary_without_volatile(golden))


@pytest.mark.parametrize("argv", [
    [],
    ["a.yaml", "b.yaml", "10"],
    ["-o", "out", "-s", "-n", "-t", "simple", "a", "b", "5"],
    ["-mpvx", "-N", "4", "-S", "2", "a", "b", "7"],
    ["-q", "a", "b", "3"],
    ["-t", "cycle", "-o", "x/y", "a", "-", "b", "1"],
])
def test_flags_parse_as_in_jax(argv, capsys):
    assert cli.parse_args(list(argv)) == jax_cli.parse_args(list(argv))
    assert cli.USAGE == jax_cli.USAGE


def _outputs(main, argv, out_dir):
    """Run a CLI's main from the fixtures directory; returns (rc, the
    files it wrote under ``out_dir``)."""
    rc = main(["-o", str(out_dir)] + argv)
    return rc, sorted(p.name for p in out_dir.iterdir())


@pytest.mark.parametrize("sane", [False, True], ids=["reference", "sane"])
@pytest.mark.parametrize("flags", [["-s"], ["-v", "-p"], ["-m", "-x"],
                                   ["-s", "-x"], []])
def test_trace_wiring_matches_jax(sane, flags, exact, tmp_path, monkeypatch):
    """The same flags make both CLIs write the same files: the reference
    wiring (-s drives four traces, -v/-p/-m alone write none) or, with
    SANAFE_TPU_SANE_TRACES=1, one trace a flag."""
    if sane:
        monkeypatch.setenv("SANAFE_TPU_SANE_TRACES", "1")
    monkeypatch.chdir(FIXTURES)
    argv = flags + ["-n", "-t", "simple", "arch_hh.yaml", "snn_hh.net", "5"]
    got = _outputs(cli.main, argv, tmp_path / "port")
    monkeypatch.delenv("SANAFE_TPU_CLI_EXACT")  # sanafe_tpu's CPU path
    want = _outputs(jax_cli.main, argv, tmp_path / "jax")
    assert got == want
    assert got[0] == 0 and "run_summary.yaml" in got[1]
    expected = {"run_summary.yaml"}
    if "-s" in flags:
        expected |= {"spikes.csv"} if sane else {
            "spikes.csv", "potentials.csv", "perf.csv", "messages.csv"}
    if sane:
        expected |= {"potentials.csv"} if "-v" in flags else set()
        expected |= {"perf.csv"} if "-p" in flags else set()
        expected |= {"messages.csv"} if "-m" in flags else set()
    if "-x" in flags:
        expected |= {"neurons.csv"}
    assert set(got[1]) == expected


@pytest.mark.parametrize("argv,message", [
    (["only", "two"], "Usage"),
    (["arch_hh.yaml", "snn_hh.net", "ten"], "Invalid time-steps"),
    (["arch_hh.yaml", "snn_hh.net", "0"], "Time-steps must be > 0"),
    (["missing_arch.yaml", "snn_hh.net", "10"], "Error:"),
    (["-n", "arch_hh.yaml", "missing.net", "10"], "Error:"),
])
def test_error_exits_match_jax(argv, message, exact, monkeypatch, capsys,
                               tmp_path):
    monkeypatch.chdir(FIXTURES)
    argv = ["-o", str(tmp_path)] + argv
    assert cli.main(argv) == 1
    port_err = capsys.readouterr().err
    monkeypatch.delenv("SANAFE_TPU_CLI_EXACT")
    assert jax_cli.main(argv) == 1
    jax_err = capsys.readouterr().err
    assert message in port_err
    assert port_err.splitlines()[-1] == jax_err.splitlines()[-1]


def test_without_a_card_exits_1(monkeypatch, capsys, tmp_path):
    """No SANAFE_TPU_CLI_EXACT: the card in float32, never the CPU on its
    own. Without CUDA that is SpikingChip's error and exit code 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI runs on it")
    monkeypatch.delenv("SANAFE_TPU_CLI_EXACT", raising=False)
    monkeypatch.chdir(FIXTURES)
    rc = cli.main(["-o", str(tmp_path), "-s", "-n", "arch_hh.yaml",
                   "snn_hh.net", "10"])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_module_entry_point(tmp_path):
    """``python -m sanafe_tpu_torch.cli`` runs main() and exits with its
    code (here the usage error, 1)."""
    result = subprocess.run(
        [sys.executable, "-m", "sanafe_tpu_torch.cli", "only_two", "args"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert result.returncode == 1
    assert "Usage" in result.stderr
