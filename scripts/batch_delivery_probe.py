#!/usr/bin/env python3
"""The sample-batched delivery kernel's time on the full random network.

    python3 scripts/batch_delivery_probe.py                # on a card
    python3 scripts/batch_delivery_probe.py --root build/parent

Builds ``chip_smoke.py``'s ``full`` chip (the TCAD'25 random network, 128
cores x 256 neurons, float32), runs 50 steps of the step scan for its
step-50 fired pattern and 50 steps of ``chip_smoke.py``'s 16-threshold
``ParameterSweep`` for the planes the sweep's batched delivery takes at
step 50 (``chip_smoke.sweep_plane``), and times ``delivery_batch_kernel``
on three inputs, with its launches queued ahead (``chip_smoke.queued_ms``:
the card sleeps while the host enqueues the calls) and back to back by
CUDA events (which the wrapper's host time sets where the kernels take
microseconds):

- ``step50``: the step-50 pattern in every sample, at 1, 4, 16 and 64
  samples, reading the live rows (the sweep's ``build_live_rows`` list);
- ``sweep``: the sweep's own 16 planes, whose samples' masks differ;
- ``all_rows``: the step-50 pattern with every row listed
  (``every_row_live``: what dense connectivity gives), at 1, 4, 16, 64.

Each case is first held bit for bit to ``delivery_batch_plain`` on the
same card tensors. Beside the times: the bound (``chip_smoke.batch_bounds``:
the live rows some sample fired, and the dense figure of every fired
row), 16 launches of ``delivery_kernel``, and the library calls at 16
samples: ``torch.sparse.mm`` of the transposed CSR matrix of the non-zero
cells and ``torch.mm`` of the dense float32 matrix against the fired
planes. With ``--root DIR`` (another checkout, e.g. an older commit
unpacked with ``git archive``) that checkout's ``ops/delivery.py`` is
imported under another package name and called with its own signature (a
wrapper with no live-row list reads every fired row in every case), its
kernel built from its own ``csrc/``, held to the plain version, and the
two are timed in turns: old, new, new, old. Prints the card's name and
power limit on every line.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import sys
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the chips' recipes, bounds, cuda_ms)

SAMPLES = (1, 4, 16, 64)
REPS = 20


def other_delivery(root: Path):
    """``ops/delivery.py`` of the checkout under ``root``, imported as a
    package of another name: its wrapper builds and loads that checkout's
    kernel into that checkout's build directory."""
    name = "sanafe_tpu_torch_other"
    pkg = types.ModuleType(name)
    pkg.__path__ = [str(Path(root).resolve() / "sanafe_tpu_torch")]
    sys.modules[name] = pkg
    return importlib.import_module(f"{name}.ops.delivery")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=None,
                        help="another checkout whose kernel runs in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("batch_delivery_probe: no CUDA device", file=sys.stderr)
        return 2
    import sanafe_tpu_torch as st
    from sanafe_tpu_torch.compile import compile_chip
    from sanafe_tpu_torch.ops import delivery
    from sanafe_tpu_torch.ops.scan import run_scan
    from sanafe_tpu_torch.ops.step import make_device_program

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    compiled = compile_chip(*chip_smoke.random_chip(st, **chip_smoke.FULL))
    prog = make_device_program(compiled, "cuda", torch.float32,
                               record_fired_axons=True)
    _, out = run_scan(prog, prog.init_state(), 1, 50)
    n = compiled.n_neurons
    one = np.zeros(prog.block.n_pad, dtype=bool)
    one[:n] = np.unpackbits(out["masks_packed"][-1, 0].cpu().numpy())[:n] > 0
    del out, prog
    torch.cuda.empty_cache()

    arch, net = chip_smoke.random_chip(st, **chip_smoke.FULL)
    chip = st.SpikingChip(arch, device="cuda")
    chip.load(net)
    values = np.linspace(0.5, 4.0, chip_smoke.PARAM_SAMPLES) * float(
        chip.compiled.threshold[0])
    sweep = st.ParameterSweep(chip, {"threshold": st.expand_group_values(
        chip.compiled, "threshold", {"pop": values})})
    sweep_x = chip_smoke.sweep_plane(sweep, chip_smoke.PARAM_CAPTURE_STEP)
    blk = sweep.prog.block  # the live rows alone
    dblk = chip_smoke.dense_of(blk)  # the dense blocks again
    live = sweep.arrays["block_batch_plan"].live_rows
    every = delivery.every_row_live(blk.n_blocks, blk.tile, "cuda")
    # the plain version (and an older kernel) take the dense blocks; the
    # kernels the listed rows alone
    shared = (dblk.weights, dblk.arrivals, blk.src_tiles, blk.dest_offsets,
              blk.max_blocks_per_dest)
    held = {id(rows): delivery.compact_blocks(dblk.weights, dblk.arrivals,
                                              rows)[1:]
            for rows in (live, every)}
    one_x = torch.from_numpy(one).to(device="cuda", dtype=torch.float32).view(
        blk.n_tiles, blk.tile)

    old = other_delivery(args.root) if args.root is not None else None
    # an older wrapper may take no live-row list
    old_takes_list = old is not None and len(inspect.signature(
        old.delivery_batch_kernel).parameters) > len(shared) + 1

    def runner(label, rows):
        if label == "new":
            return lambda x: delivery.delivery_batch_kernel(
                x, *held[id(rows)], *shared[2:], rows)
        if old_takes_list:
            return lambda x: old.delivery_batch_kernel(x, *shared, rows)
        return lambda x: old.delivery_batch_kernel(x, *shared)

    labels = ["new"] if old is None else ["old", "new", "new", "old"]
    cases = [("step50", samples, live) for samples in SAMPLES]
    cases.append(("sweep", chip_smoke.PARAM_SAMPLES, live))
    cases += [("all_rows", samples, every) for samples in SAMPLES]
    for kind, samples, rows in cases:
        x = (sweep_x if kind == "sweep"
             else one_x.expand(samples, -1, -1).contiguous())
        ref = delivery.delivery_batch_plain(x, *shared)
        times = []
        for label in labels:
            fn = runner(label, rows)
            got = fn(x)
            torch.cuda.synchronize()
            if not (chip_smoke.same_bits(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise SystemExit(f"{label} kernel differs from "
                                 f"delivery_batch_plain ({kind}, "
                                 f"B={samples})")
            times.append((label, chip_smoke.queued_ms(lambda: fn(x), REPS),
                          chip_smoke.cuda_ms(lambda: fn(x), REPS)))
        b = chip_smoke.batch_bounds(x, blk, rows)
        print(f"batch_delivery: {kind} B={samples} fired {int(x.sum())}, "
              f"{b['rows']} listed fired rows: (queued ms, back-to-back "
              f"ms) in turns {times}; bound "
              f"{b['ms']} ms ({b['by']}; {b['bytes']} B, {b['adds']} adds); "
              f"the dense figure {b['dense_ms']} ms ({b['dense_by']}) "
              f"| {card}", flush=True)
        del x, ref, got

    x1 = one_x

    def sixteen():
        for _ in range(chip_smoke.PARAM_SAMPLES):
            delivery.delivery_kernel(x1, *held[id(live)], *shared[2:], live)

    single_ms = chip_smoke.queued_ms(sixteen, 3)
    dense = chip_smoke.dense_weights(dblk)
    csr = chip_smoke.csr_weights(dblk)
    for kind, x in (("step50", one_x.expand(chip_smoke.PARAM_SAMPLES, -1,
                                            -1).contiguous()),
                    ("sweep", sweep_x)):
        lhs = x.reshape(x.shape[0], -1)
        rhs = lhs.t().contiguous()
        mm_ms = chip_smoke.queued_ms(lambda: torch.mm(lhs, dense), REPS)
        sp_ms = chip_smoke.queued_ms(lambda: torch.sparse.mm(csr, rhs), REPS)
        cur = delivery.delivery_batch_kernel(
            x, *held[id(live)], *shared[2:], live)[0].reshape(x.shape[0], -1)
        err = max(float((torch.mm(lhs, dense) - cur).abs().max()),
                  float((torch.sparse.mm(csr, rhs).t() - cur).abs().max()))
        print(f"batch_delivery: {kind} B={x.shape[0]} library calls, queued "
              f"ms: torch.sparse.mm of the transposed CSR matrix "
              f"({csr.values().numel()} non-zero cells) {sp_ms} ms, torch.mm "
              f"against the dense {blk.n_pad}^2 float32 matrix {mm_ms} ms "
              f"(largest difference from the kernel's currents {err}) "
              f"| {card}", flush=True)
    print(f"batch_delivery: {chip_smoke.PARAM_SAMPLES} delivery_kernel "
          f"launches {single_ms} ms (queued) | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
