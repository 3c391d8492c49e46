"""Readings for the limits of ``correct``, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control tf32|bf16|float32] [--fault <f>]

Without ``--control`` each seed is a run of the program (set-up, a window
of ``--seconds``, the comparison with the reference), whose numbers give
the lower readings. With ``--control`` the reference itself, at that
precision, takes the program's place (``tf32``: float32 with TF32 products,
the nearest precision below a float32 configuration that keeps TF32 off;
``bf16``; ``float32``); with ``--fault`` also, the reference at the
configuration's precision with a planted fault (``harness/control.py``).
Prints one JSON line a seed: the numbers compared and whether the current
limits pass them."""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", choices=("tf32", "bf16", "float32"))
    parser.add_argument("--fault")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import control, judge, runner, spec

    cell = spec.Cell(spec.load_benchmark(ROOT / "BENCHMARK.json"),
                     args.workload)
    calls = None
    if args.control or args.fault:
        dtype = {"tf32": torch.float32, "bf16": torch.bfloat16,
                 "float32": torch.float32, None: torch.float32}[args.control]
        calls = control.factory(dtype=dtype,
                                allow_tf32=args.control == "tf32",
                                fault=args.fault)
    limits = judge.load_limits(cell.name, cell.bench_dir)
    for seed in args.seeds:
        start = time.perf_counter()
        run = runner.run_cell(cell, seed, args.seconds, False, args.device,
                              start, log=lambda text: None, calls=calls)
        ok, _ = judge.verdict(run["found"], limits)
        steps = sum(c.steps * c.samples for c in run["calls"])
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": args.control,
            "fault": args.fault, "found": run["found"], "passes": ok,
            "calls": len(run["calls"]), "rate": steps / run["window_s"],
            "setup_s": run["setup_s"],
            "seconds": time.perf_counter() - start}), flush=True)
        del run
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
