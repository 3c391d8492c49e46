"""Run one cell of the benchmark of ``sanafe_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for. ``BENCHMARK.json`` names the cells; each cell's configuration,
traffic mix, metrics and limits are files of their own under
``benchmark/``. With ``--trace 0`` the run measures the cell's end-to-end
metrics over a window of ``--seconds``; with ``--trace 1`` it profiles the
traffic's ``trace_calls`` calls and reports the per-layer metrics. Either
way it then compares what the timed calls produced with the plain
reference (``benchmark/reference/``). The last line of standard output is
one JSON object; the last lines of standard error are the numbers compared,
each with its limit. Without the CUDA devices the cell asks for, or with
JAX or the JAX package loaded, it prints no result and exits non-zero."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import modules, report, runner, spec
    from benchmark.harness.stats import percentile

    cell = spec.Cell(spec.load_benchmark(ROOT / "BENCHMARK.json"),
                     args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        log(f"error: {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count: {torch.cuda.device_count()}")
        return 2
    run = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START, log=log)
    line = report.result_line(cell, run, bool(args.trace))
    found = modules.forbidden_loaded()
    if found:
        log(f"error: modules loaded that the benchmark forbids: {found}")
        return 3
    log(f"card: {card_line()}")
    times = [1e3 * (c.end - c.begin) for c in run["calls"]]
    log(f"window: {len(times)} calls in {run['window_s']:.3f} s; call ms "
        f"min {min(times):.3f} "
        + " ".join(f"p{q} {percentile(times, q):.3f}"
                   for q in (50, 90, 95, 99)) + f" max {max(times):.3f}")
    for text in report.check_lines(line):
        log(text)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
