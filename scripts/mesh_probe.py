#!/usr/bin/env python3
"""Timing of the routes of chip_smoke.py phases 16a-b and 17a on one CUDA
card, for one checkout of the repository.

    python3 scripts/mesh_probe.py [--root DIR]

Imports ``chip_smoke`` and ``sanafe_tpu_torch`` from DIR (default: the
checkout this script lies in), so an unpacked older commit is timed by its
own code, and runs, after a warm run of each:

- the TCAD'25 "full" random chip on one chip: MESH_SIMPLE_STEPS steps
  ``simple`` and MESH_DETAILED_STEPS ``detailed`` with the spike trace,
  steps/s on the host clock;
- the same chip on two gloo ranks on the one card (chip_smoke's
  ``launch_ranks`` and its ``full`` rank case, which holds each rank's
  counters and delivery kernel to one chip's): rank 0's steps/s and each
  rank's exchange ms a step;
- the full-width Hodgkin-Huxley chip: HH_SWEEP_STEPS steps ``simple`` on
  one chip, then the ParameterSweep of its currents x HH_SWEEP_SCALES:
  samples x steps/s and its ratio to one chip's steps/s.

Run it for two checkouts in turns within one call (parent, change, change,
parent) to compare them on one card. Prints one line per route, each ending
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    opts = parser.parse_args()
    sys.path.insert(0, str(opts.root.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import sanafe_tpu_torch as st
    from sanafe_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    card = cs.card_line()
    tag = f"root={opts.root.name}"
    cuda_build.build(*cuda_build.ALL)

    with tempfile.TemporaryDirectory(prefix="mesh_probe_") as tmp:
        tmp = Path(tmp)
        # --- one chip ---
        arch, net = cs.random_chip(st, **cs.FULL)
        chip = st.SpikingChip(arch, device=cuda)
        chip.load(net)
        chip.sim(10, heartbeat=0)
        cs.sync(cuda)
        start = time.perf_counter()
        chip.sim(cs.MESH_SIMPLE_STEPS, heartbeat=0)
        cs.sync(cuda)
        t_simple = time.perf_counter() - start
        start = time.perf_counter()
        chip.sim(cs.MESH_DETAILED_STEPS, timing_model="detailed",
                 heartbeat=0, spike_trace=tmp / "single_full_spikes.csv")
        cs.sync(cuda)
        t_det = time.perf_counter() - start
        chip.close()
        del chip
        torch.cuda.empty_cache()

        # --- two gloo ranks ---
        ranks, wall = cs.launch_ranks(cs.MESH_WORLD, "gloo", cuda, ("full",),
                                      tmp)
        single = (tmp / "single_full_spikes.csv").read_bytes()
        mesh = (tmp / f"gloo{cs.MESH_WORLD}_full_spikes.csv").read_bytes()
        cs.check(single == mesh, "full on the mesh: spikes.csv differs")
        full0 = ranks[0]["full"]
        print(f"mesh_probe: {tag} full simple {cs.MESH_SIMPLE_STEPS} steps: "
              f"one chip {cs.MESH_SIMPLE_STEPS / t_simple} steps/s, "
              f"{cs.MESH_WORLD} gloo ranks "
              f"{cs.MESH_SIMPLE_STEPS / full0['t_simple']}; detailed "
              f"{cs.MESH_DETAILED_STEPS} steps: one chip "
              f"{cs.MESH_DETAILED_STEPS / t_det}, ranks "
              f"{cs.MESH_DETAILED_STEPS / full0['t_det']}; exchange ms a "
              f"step {[r['full']['exchange_ms'] for r in ranks]}; the ranks' "
              f"delivery kernels {[r['full']['kernel_ms'] for r in ranks]} "
              f"ms; ranks' wall {wall} s | {card}", flush=True)

        # --- full HH: one chip, then the sweep of its currents ---
        arch, net = cs.hh_chip(st, **cs.FULL)
        chip = st.SpikingChip(arch, device=cuda)
        chip.load(net)
        chip.sim(cs.HH_SWEEP_STEPS, heartbeat=0)
        cs.sync(cuda)
        start = time.perf_counter()
        chip.sim(cs.HH_SWEEP_STEPS, heartbeat=0)
        cs.sync(cuda)
        one_s = cs.HH_SWEEP_STEPS / (time.perf_counter() - start)
        current = chip.compiled.plugin_params["hodgkin_huxley"]["current"]
        scales = np.asarray(cs.HH_SWEEP_SCALES)
        sweep = st.ParameterSweep(chip, {
            "plugin_hodgkin_huxley_current":
                current[None, :] * scales[:, None]})
        sweep.run(cs.HH_SWEEP_STEPS)
        cs.sync(cuda)
        start = time.perf_counter()
        sweep.run(cs.HH_SWEEP_STEPS)
        cs.sync(cuda)
        rate = len(scales) * cs.HH_SWEEP_STEPS / (time.perf_counter() - start)
        print(f"mesh_probe: {tag} full_hh {cs.HH_SWEEP_STEPS} steps: one chip "
              f"{one_s} steps/s; {len(scales)}-sample current sweep {rate} "
              f"samples x steps/s ({rate / one_s} x one chip) | {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
