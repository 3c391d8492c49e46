"""Command-line entry point: ``python -m sanafe_tpu_torch.cli`` (or the
``sanafe-tpu-torch`` script), the counterpart of ``sanafe_tpu.cli`` and of
the reference's standalone ``./sim`` binary (src/main.cpp:28-100,
src/arg_parsing.cpp:32-110).

Flags::

    -o <dir>   output directory for trace CSVs + run_summary.yaml
    -m         record message trace (messages.csv)
    -n         parse the SNN file as legacy netlist format
    -p         record perf trace (perf.csv)
    -s         record spike trace (spikes.csv)
    -t <model> timing model: simple | detailed | cycle
    -v         record potential trace (potentials.csv)
    -x         record neuron-state trace (neurons.csv)
    -N <n>     processing threads (accepted for parity; kernel is parallel)
    -S <n>     scheduler threads (accepted for parity)

Trace wiring matches the reference binary exactly (src/main.cpp:63-67):
``-s`` enables the spike, potential, perf AND message traces together, and
``-v``/``-p``/``-m`` have no effect on their own (they are parsed, like in
the reference, but main.cpp never consults them). Set
``SANAFE_TPU_SANE_TRACES=1`` to opt into the documented per-flag behavior
instead (-s spikes only, -v potentials, -p perf, -m messages).

The simulation runs on the CUDA card in float32 (bit-exact spike rasters,
last-digit energy deviations), as sanafe_tpu runs on an accelerator.
``SANAFE_TPU_CLI_EXACT=1`` runs it on the CPU in float64, the
configuration whose traces equal the reference binary's byte for byte.
Without a card and without that variable the CLI exits 1 with
``SpikingChip``'s "CUDA is not available" error; it never moves to the
CPU on its own.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import torch

from .arch import load_arch
from .chip import SpikingChip
from .network import load_net
from .yaml_arch import DescriptionParsingError


USAGE = (
    "Usage: sim [-o dir] [-mnpsvx] [-t model] [-N threads] [-S threads] "
    "<arch.yaml> <snn.yaml> <timesteps>"
)


def parse_args(argv: list[str]) -> tuple[dict, list[str]]:
    flags = {
        "output_dir": Path("."),
        "record_messages": False,
        "use_netlist_format": False,
        "record_perf": False,
        "record_spikes": False,
        "record_potentials": False,
        "record_neuron_state": False,
        "timing_model": "detailed",
        "processing_threads": 1,
        "scheduler_threads": 0,
    }
    positional: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("-") or len(arg) < 2:
            positional.append(arg)
            i += 1
            continue
        flag = arg[1]
        if flag == "o":
            flags["output_dir"] = Path(argv[i + 1])
            i += 2
        elif flag == "m":
            flags["record_messages"] = True
            i += 1
        elif flag == "n":
            flags["use_netlist_format"] = True
            i += 1
        elif flag == "p":
            flags["record_perf"] = True
            i += 1
        elif flag == "s":
            flags["record_spikes"] = True
            i += 1
        elif flag == "t":
            flags["timing_model"] = argv[i + 1]
            i += 2
        elif flag == "v":
            flags["record_potentials"] = True
            i += 1
        elif flag == "x":
            flags["record_neuron_state"] = True
            i += 1
        elif flag == "N":
            flags["processing_threads"] = int(argv[i + 1])
            i += 2
        elif flag == "S":
            flags["scheduler_threads"] = int(argv[i + 1])
            i += 2
        else:
            print(f"Error: Flag {flag} not recognized.", file=sys.stderr)
            i += 1
    return flags, positional


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags, positional = parse_args(argv)
    if len(positional) != 3:
        print(USAGE, file=sys.stderr)
        return 1
    arch_path, net_path, timesteps_arg = positional
    try:
        timesteps = int(timesteps_arg)
    except ValueError:
        print(f"Error: Invalid time-steps: {timesteps_arg}", file=sys.stderr)
        return 1
    if timesteps <= 0:
        print(f"Error: Time-steps must be > 0 ({timesteps})", file=sys.stderr)
        return 1

    # The reference computes everything in C++ double; byte-identical trace
    # output needs float64, which SANAFE_TPU_CLI_EXACT=1 asks for on the
    # CPU. Otherwise the card runs float32.
    if os.environ.get("SANAFE_TPU_CLI_EXACT", "0") == "1":
        device, dtype = "cpu", torch.float64
    else:
        device, dtype = "cuda", torch.float32

    # Reference trace-flag wiring (src/main.cpp:63-67): -s drives the
    # spike/potential/perf/message traces together; only -x acts alone.
    if os.environ.get("SANAFE_TPU_SANE_TRACES", "0") != "1":
        record_spikes = flags["record_spikes"]
        flags["record_potentials"] = record_spikes
        flags["record_perf"] = record_spikes
        flags["record_messages"] = record_spikes

    out = Path(flags["output_dir"])
    try:
        arch = load_arch(arch_path)
        print("Architecture initialized.")
        net = load_net(net_path, arch, flags["use_netlist_format"])
        print("Network initialized.")
        try:
            chip = SpikingChip(arch, device=device, dtype=dtype)
        except RuntimeError as exc:  # "CUDA is not available"
            print(f"Error: {exc}", file=sys.stderr)
            return 1
        chip.load(net)
        print("Running simulation.")
        out.mkdir(parents=True, exist_ok=True)
        run_data = chip.sim(
            timesteps,
            timing_model=flags["timing_model"],
            processing_threads=flags["processing_threads"],
            scheduler_threads=flags["scheduler_threads"],
            spike_trace=(
                str(out / "spikes.csv") if flags["record_spikes"] else None
            ),
            potential_trace=(
                str(out / "potentials.csv")
                if flags["record_potentials"]
                else None
            ),
            neuron_trace=(
                str(out / "neurons.csv")
                if flags["record_neuron_state"]
                else None
            ),
            perf_trace=(
                str(out / "perf.csv") if flags["record_perf"] else None
            ),
            message_trace=(
                str(out / "messages.csv")
                if flags["record_messages"]
                else None
            ),
        )
        chip.close()
        print("***** Run Summary *****")
        chip.sim_output_run_summary(out, run_data)
        print(f"Average power consumption: {chip.get_power():f} W.")
        print("Run finished.")
        return 0
    except DescriptionParsingError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    except FileNotFoundError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
