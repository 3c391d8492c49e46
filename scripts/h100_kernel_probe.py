#!/usr/bin/env python3
"""Probe of the delivery and whole-chunk kernels on one CUDA card.

    python3 scripts/h100_kernel_probe.py [--root DIR] [--skip-full] [--dvs]
        [--skip-chunk]

Builds the kernels of the sanafe_tpu_torch package under DIR (default: the
checkout this script lies in), holds each against its plain version and
times it with CUDA events:

- delivery: the 4096-neuron random chip in float64 and (unless
  --skip-full) the 32,768-neuron TCAD'25 "full" random chip in float32, on
  five fired patterns (none, half of one tile, 25%, all, and "mixed": every
  other source tile fired whole, the rest silent), and (with --dvs) the
  DVS-gesture net's edges all as blocks in float32 with a seeded 7%, 25%
  and all of its neurons fired; ms per call with the launches queued
  ahead of the card, so the wrapper's host time is left out (a package
  whose kernel reads the live-row list: launches on its checked operands,
  and beside them delivery_batch_kernel's at one sample on the same list);
  each held to its plain versions: the listed kernel bit for bit to
  delivery_live_plain, an older one within rounding of delivery_plain;
- chunk: the 384-neuron random chip and load_example(), 1000 steps, for
  every cluster size the package's kernel takes (an older package without
  the ``cluster`` argument is timed as it is), ms per chunk.

DIR may be an unpacked older commit of the repository: the script adapts to
the older delivery interfaces (int8 counts instead of the packed arrival
plane; no live-row list), so two commits can be timed in turns on one card
within one call.
Prints one line per measurement, each ending with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

PATTERNS = ("none", "one_tile", "25pct", "all", "mixed")


def fired_plane(blk, n, pattern, dtype, device):
    import torch

    rng = np.random.default_rng(7)
    fired = np.zeros(blk.n_pad, dtype=bool)
    if pattern == "one_tile":
        lo = blk.tile if blk.n_tiles > 1 else 0
        fired[lo : lo + blk.tile] = rng.random(blk.tile) < 0.5
    elif pattern == "25pct":
        fired[:n] = rng.random(n) < 0.25
    elif pattern == "7pct":
        fired[:n] = rng.random(n) < 0.07
    elif pattern == "all":
        fired[:n] = True
    elif pattern == "mixed":
        whole = np.arange(blk.n_tiles) % 2 == 0
        fired = np.repeat(whole, blk.tile)
        fired[n:] = False
    return torch.from_numpy(fired).to(device=device, dtype=dtype).view(
        blk.n_tiles, blk.tile)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--skip-full", action="store_true")
    parser.add_argument("--dvs", action="store_true")
    parser.add_argument("--skip-chunk", action="store_true")
    opts = parser.parse_args()
    sys.path.insert(0, str(opts.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("h100_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import sanafe_tpu_torch as st
    from sanafe_tpu_torch.compile import compile_chip
    from sanafe_tpu_torch.ops import chunk, cuda_build, delivery
    from sanafe_tpu_torch.ops.step import build_block_delivery

    cuda = torch.device("cuda")
    card = cs.card_line()
    tag = f"root={opts.root.name}"
    build_s = cuda_build.build(cuda_build.CHUNK, cuda_build.DELIVERY)
    for lib in (cuda_build.CHUNK, cuda_build.DELIVERY):
        usage = [line.strip() for line in lib.log.read_text().splitlines()
                 if "registers" in line or "spill" in line]
        print(f"build: {tag} {lib.name} ({build_s} s) {usage}", flush=True)
    packed = hasattr(delivery, "pack_arrival_plane")
    # a wrapper that takes the live-row list (and reads only those rows)
    listed = hasattr(delivery, "delivery_live_plain")

    # --- delivery ---
    chips = [("mid", lambda: cs.random_chip(st, **cs.MID), torch.float64,
              PATTERNS)]
    if not opts.skip_full:
        chips.append(("full", lambda: cs.random_chip(st, **cs.FULL),
                      torch.float32, PATTERNS))
    if opts.dvs:
        chips.append(("dvs", lambda: cs.dvs_chip(st), torch.float32,
                      ("7pct", "25pct", "all")))
    for name, make_chip, dtype, patterns in chips:
        compiled = compile_chip(*make_chip())
        blk = build_block_delivery(compiled, dtype, cuda)
        third = (delivery.pack_arrival_plane(blk.counts) if packed
                 else blk.counts)
        live = delivery.build_live_rows(blk.weights, third) if listed else None
        for pattern in patterns:
            x = fired_plane(blk, compiled.n_neurons, pattern, dtype, cuda)
            args = (x, blk.weights, third, blk.src_tiles, blk.dest_offsets,
                    blk.max_blocks_per_dest)
            if listed:
                args += (live,)
            cur, arrived = delivery.delivery_kernel(*args)
            ref_cur, ref_cnt = delivery.delivery_plain(
                x, blk.weights, blk.counts, blk.src_tiles, blk.dest_offsets,
                blk.max_blocks_per_dest)
            torch.cuda.synchronize()
            if not packed:
                arrived = arrived > 0
            ok = torch.equal(cur, ref_cur) and torch.equal(arrived,
                                                           ref_cnt > 0)
            # an older kernel added warp partials: within rounding of the
            # plain version's order on real weights
            close = torch.equal(arrived, ref_cnt > 0) and torch.allclose(
                cur, ref_cur, rtol=1e-5, atol=1e-5)
            extra = ""
            if listed:
                live_cur, live_arrived = delivery.delivery_live_plain(*args)
                close = close and cs.same_bits(cur, live_cur) and torch.equal(
                    arrived, live_arrived)
                fired_live = cs.live_fired(x[None], blk, live)[0]
                extra = f" live rows fired {fired_live} of {live.count}"
            if listed:
                plan = delivery.plan_delivery(*args[1:])
                ms = cs.queued_ms(lambda: delivery.delivery_launch(x, plan),
                                  50)
                bplan = delivery.plan_delivery_batch(1, *args[1:])
                xb = x[None].contiguous()
                batch_ms = cs.queued_ms(
                    lambda: delivery.delivery_batch_launch(xb, bplan), 50)
                extra += f" delivery_batch_kernel B=1 {batch_ms} ms"
            else:
                # launches queued ahead of the card, as the listed kernel's
                ms = cs.queued_ms(lambda: delivery.delivery_kernel(*args), 50)
            rows = x.sum(dim=1)[blk.src_tiles.long()]
            read_b = float(rows.sum()) * blk.tile * (
                x.element_size() + (1 / 8 if packed else 1))
            print(f"delivery: {tag} {name} {str(dtype)[6:]} tile={blk.tile} "
                  f"blocks={blk.weights.shape[0]} pattern={pattern} fired="
                  f"{int(x.sum())}{extra} equal_to_plain={ok} "
                  f"within_rounding={close} {ms} ms "
                  f"({read_b / ms * 1e-6} GB/s of fired rows) | {card}",
                  flush=True)
            if not close:
                return 1
        del blk, third, args, cur, arrived, ref_cur, ref_cnt, x, live
        torch.cuda.empty_cache()

    if opts.skip_chunk:
        return 0

    # --- chunk ---
    clustered = hasattr(chunk, "MAX_CLUSTER")
    sizes = (1, 2, 4, 8, 16) if clustered else (None,)
    for name, make_chip in (("random384", lambda: cs.random_chip(st)),
                            ("example", st.load_example)):
        compiled = compile_chip(*make_chip())
        plain = cs.ChunkCase(compiled, "cpu", {}, cs.STEPS)
        kern = cs.ChunkCase(compiled, cuda, {}, cs.STEPS)
        ref = plain.decode(*plain.run(chunk.chunk_plain))
        for size in sizes:
            kwargs = {} if size is None else {"cluster": size}

            def run():
                return chunk.chunk_kernel(kern.plan, kern.mats, kern.rows, 1,
                                          kern.n_steps, *kern.planes,
                                          **kwargs)
            got = kern.decode(*run())
            torch.cuda.synchronize()
            err = cs.compare_chunks(ref, got, f"{name} cluster {size}")
            ms = cs.cuda_ms(run, 5)
            chosen = (chunk.default_cluster(kern.plan) if clustered
                      else None)
            print(f"chunk: {tag} {name} npad={kern.plan.npad} "
                  f"M={kern.plan.m_cols} T={cs.STEPS} cluster={size} "
                  f"(default {chosen}) max_abs_err={err} {ms} ms "
                  f"({cs.STEPS / ms * 1e3} steps/s) | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
