#!/usr/bin/env python3
"""The sample-batched delivery kernel's time on the full random network.

    python3 scripts/batch_delivery_probe.py                # on a card
    python3 scripts/batch_delivery_probe.py --root build/parent

Builds ``chip_smoke.py``'s ``full`` chip (the TCAD'25 random network, 128
cores x 256 neurons, float32), runs 50 steps of the step scan on the card
for its step-50 fired pattern, and times ``delivery_batch_kernel`` by CUDA
events at 1, 4, 16 and 64 samples on two kinds of input:

- ``same``: the step-50 pattern in every sample (every row a thread holds
  is fired by all its samples);
- ``varied``: sample b keeps each fired neuron of that pattern with a
  seeded probability 0.95, so masks differ row by row.

Each case is first held bit for bit to ``delivery_batch_plain`` on the
same card tensors. Beside the times: 16 launches of ``delivery_kernel``,
``torch.mm`` of the 16 rows against the dense float32 matrix, and the
bound (the union's fired rows and arrival bits over 3.35 TB/s, one float
add a cell a sample over 33.5 T adds/s). With ``--root DIR`` (another
checkout, e.g. an older commit unpacked with ``git archive``) that
checkout's kernel is built too (``scripts/chain_floor.py:using``), held to
the plain version, and the two are timed in turns: old, new, new, old.
Prints the card's name and power limit on every line.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the chips' recipes, bound, cuda_ms)
import chain_floor  # noqa: E402  (scripts/: another checkout's kernel)

SAMPLES = (1, 4, 16, 64)
KEEP = 0.95  # varied: each fired neuron stays fired in a sample this often
REPS = 10


def planes(one: np.ndarray, samples: int, kind: str, blk):
    rows = np.repeat(one[None], samples, axis=0)
    if kind == "varied":
        rng = np.random.default_rng(11)
        rows &= rng.random(rows.shape) < KEEP
    return torch.from_numpy(rows).to(device="cuda", dtype=torch.float32).view(
        samples, blk.n_tiles, blk.tile)


def bound_of(x, blk) -> tuple:
    """Bytes of the union's fired rows (a float32 and an arrival bit a
    cell), the planes read and the results written; adds: one a cell a
    sample of each sample's fired rows."""
    src = blk.src_tiles.long()
    union = (x.sum(dim=0) > 0).to(torch.float32)
    rows = int(union.sum(dim=1)[src].sum())
    adds = int(x.sum(dim=2)[:, src].sum()) * blk.tile
    words = blk.arrivals.shape[2]
    n_bytes = (rows * (blk.tile * 4 + words * 4)
               + x.shape[0] * blk.n_pad * (4 + 4 + 1)
               + blk.src_tiles.numel() * 4 + blk.dest_offsets.numel() * 4)
    return chip_smoke.bound(n_bytes, adds, chip_smoke.F32_ADDS_S)


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
    blk = prog.block
    one = np.zeros(blk.n_pad, dtype=bool)
    one[:n] = np.unpackbits(out["masks_packed"][-1, 0].cpu().numpy())[:n] > 0
    del out
    shared = (blk.weights, blk.arrivals, blk.src_tiles, blk.dest_offsets,
              blk.max_blocks_per_dest)

    def launch(x):
        return delivery.delivery_batch_kernel(x, *shared)

    turns = [("new", None)]
    if args.root is not None:
        turns = [("old", args.root), ("new", None), ("new", None),
                 ("old", args.root)]
    for kind in ("same", "varied"):
        for samples in SAMPLES:
            x = planes(one, samples, kind, blk)
            ref = delivery.delivery_batch_plain(x, *shared)
            times = []
            for label, root in turns:
                if root is None:
                    got = launch(x)
                    ms = chip_smoke.cuda_ms(lambda: launch(x), REPS)
                else:
                    with chain_floor.using(root, "delivery_batch"):
                        got = launch(x)
                        ms = chip_smoke.cuda_ms(lambda: launch(x), REPS)
                torch.cuda.synchronize()
                if not (chip_smoke.same_bits(got[0], ref[0])
                        and torch.equal(got[1], ref[1])):
                    raise SystemExit(f"{label} kernel differs from "
                                     f"delivery_batch_plain ({kind}, "
                                     f"B={samples})")
                times.append((label, ms))
            bound_ms, bound_by = bound_of(x, blk)
            print(f"batch_delivery: {kind} B={samples} fired "
                  f"{int(x.sum())} ms in turns {times}; bound {bound_ms} ms "
                  f"({bound_by}) | {card}", flush=True)
            del x, ref, got
    x1 = planes(one, 1, "same", blk)[0]

    def sixteen():
        for _ in range(16):
            delivery.delivery_kernel(x1, *shared)

    single_ms = chip_smoke.cuda_ms(sixteen, 3)
    dense = torch.zeros((blk.n_pad, blk.n_pad), dtype=torch.float32,
                        device="cuda")
    dense.view(blk.n_tiles, blk.tile, blk.n_tiles, blk.tile).permute(
        0, 2, 1, 3).index_put_(
        (blk.src_tiles.long(), blk.dest_tiles.long()), blk.weights,
        accumulate=True)
    lhs = x1.reshape(1, -1).expand(16, -1).contiguous()
    mm_ms = chip_smoke.cuda_ms(lambda: torch.mm(lhs, dense), REPS)
    print(f"batch_delivery: 16 delivery_kernel launches {single_ms} ms; "
          f"torch.mm of 16 rows against the dense {blk.n_pad}^2 float32 "
          f"matrix {mm_ms} ms | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
