#!/usr/bin/env python3
"""Where the delivery kernel walks the edge cells faster than the live rows.

    python3 scripts/delivery_crossover.py [out.jsonl]     # on a card

The rows' kernel reads only the live rows whose source fired; the cells'
kernel reads every edge cell, each destination's as one chain of adds. This
times both (``delivery_launch`` on each layout's plan, launches queued
ahead: ``chip_smoke.queued_ms``, cells and rows in turns) on the same chips
at seeded random fired planes of several shares, and holds their currents
and arrivals to each other bit for bit. The chips: ``chip_smoke.py``'s
``full`` and ``mid`` random networks, TCAD'25's ``tcad25_full1024``
(``benchmark/configs``) and the DVS-gesture net with every edge on the
kernel's path (as ``SANAFE_CONV_DELIVERY=0`` builds it), whose last
layer's lists are long. One JSON line a chip and share: the cells, the
longest list, the live rows, the fired rows (live rows whose source
fired) with their bytes, and the two times in ms; ``ops/delivery.py``'s
cost constants (``delivery_us``) are fitted to them. Prints the card's name
and power limit on every line.
"""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import sanafe_tpu_torch as st  # noqa: E402
from sanafe_tpu_torch.ops import delivery  # noqa: E402
from sanafe_tpu_torch.ops.step import (  # noqa: E402
    build_block_cells,
    build_block_delivery,
)

SHARES = (1.0, 0.5, 0.25, 0.12, 0.06, 0.03, 0.015, 0.0)
REPS = 50


def compiled(name: str, cuda):
    """The compiled chip ``name`` (what a program is built from)."""
    if name in ("full", "mid"):
        arch, net = chip_smoke.random_chip(
            st, **getattr(chip_smoke, name.upper()))
    elif name == "full1024":
        from benchmark.harness import network, spec

        configs = spec.BENCH_DIR / "configs"
        cfg = json.loads(
            (configs / f"{chip_smoke.FULL1024_CONFIG}.json").read_text())
        module = spec.load_module(
            configs / f"{chip_smoke.FULL1024_CONFIG}.py", "crossover_full1024")
        arch, net = network.build_network(
            st, module.describe(cfg, chip_smoke.FULL1024_SEED))
    else:
        arch, net = chip_smoke.dvs_chip(st)
    chip = st.SpikingChip(arch, device=cuda, dtype=torch.float32)
    chip.load(net)
    return chip._compiled_for_programs()


def main() -> int:
    out = Path(sys.argv[1] if len(sys.argv) > 1
               else ROOT / "chiprun_out" / "delivery_crossover.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    cuda = torch.device("cuda")
    card = chip_smoke.card_line()
    with out.open("w") as sink:
        for name in ("full", "mid", "dvs", "full1024"):
            c = compiled(name, cuda)
            rows = build_block_delivery(c, torch.float32, cuda,
                                        live_only=True, hold_rows=True)
            cells = build_block_cells(c, torch.float32, cuda)
            shape = (rows.n_tiles, rows.tile)
            row_plan = delivery.plan_delivery(
                rows.weights, rows.arrivals, rows.src_tiles,
                rows.dest_offsets, rows.max_blocks_per_dest, rows.live_rows)
            cell_plan = delivery.plan_delivery_cells(cells.cells, shape)
            # each live row's source neuron: its block's source tile, its row
            live = rows.live_rows
            block = torch.repeat_interleave(
                torch.arange(rows.n_blocks, device=cuda),
                live.offsets.diff().long())
            source = (rows.src_tiles.long()[block] * rows.tile
                      + live.rows[:live.count].long())
            row_bytes = rows.tile * 4 + rows.arrivals.shape[1] * 4
            gen = torch.Generator(device=cuda)
            for share in SHARES:
                gen.manual_seed(int(share * 1000) + 17)
                fired = torch.rand(rows.n_pad, device=cuda,
                                   generator=gen) < share
                fired[c.n_neurons:] = False
                x = fired.to(torch.float32).view(shape).contiguous()
                got_c = delivery.delivery_launch(x, cell_plan)
                got_r = delivery.delivery_launch(x, row_plan)
                chip_smoke.check(
                    chip_smoke.same_bits(got_c[0], got_r[0])
                    and torch.equal(got_c[1], got_r[1]),
                    f"{name} at {share}: cells and rows differ")
                turns = [chip_smoke.queued_ms(
                    (lambda: delivery.delivery_launch(x, cell_plan))
                    if kind == "cells"
                    else (lambda: delivery.delivery_launch(x, row_plan)),
                    REPS) for kind in ("cells", "rows", "rows", "cells")]
                fired_rows = int(fired[source].sum())
                line = {
                    "chip": name, "n": c.n_neurons, "share": share,
                    "fired": int(fired.sum()), "cells": cells.cells.count,
                    "slots": cells.cells.src.numel(),
                    "longest": cells.cells.longest,
                    "live_rows": live.count, "fired_rows": fired_rows,
                    "fired_row_bytes": fired_rows * row_bytes,
                    "cell_bytes": cells.cells.count * 8,
                    "cells_ms": (turns[0] + turns[3]) / 2,
                    "rows_ms": (turns[1] + turns[2]) / 2,
                    "turns": turns, "card": card,
                }
                sink.write(json.dumps(line) + "\n")
                sink.flush()
                print(json.dumps(line), flush=True)
            del rows, cells, row_plan, cell_plan, live, block, source, c
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
