#!/usr/bin/env python3
"""What each part of the sample-batched delivery kernel costs on the card.

    python3 scripts/batch_delivery_variants.py            # on a card

Builds patched copies of ``sanafe_tpu_torch/csrc/delivery_batch_kernel.cu``
(``VARIANTS``: each a list of (text, replacement) pairs; the script stops
if a text is gone from the source) into ``sanafe_tpu_torch/build/variants/``
with the package's flags, prints each build's registers and spills, and
times each through the package's wrapper (its library swapped in), its
launches queued ahead (``chip_smoke.queued_ms``), on ``chip_smoke.py``'s ``full``
chip with every neuron fired, at 1, 16 and 64 samples, reading the live
rows (``build_live_rows``) and every row (``every_row_live``). The kernel
as built is first held bit for bit to ``delivery_batch_plain``; the
variants that leave out work give wrong sums and are only timed:

- ``no_adds``: the adder warps wait and free each stage without adding;
- ``no_copies``: the copier warps copy nothing (the adders add stale
  shared memory);
- ``neither``: only the producer and the hand-offs;
- ``producer_only``: the producer lists every stage without waiting for
  free slots, and the other warps leave at once;
- ``four_copiers``: 4 copier warps at every sample count (as built: 8
  below 16 samples a thread);
- ``stage_unrolled``: the adds' loop over a stage's batches unrolled;
- ``branch_a_row``: no batch-wide test, each row takes its own branch.

Prints the card's name and power limit on every line.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the full chip's recipe, queued_ms)

SOURCE = ROOT / "sanafe_tpu_torch" / "csrc" / "delivery_batch_kernel.cu"
BUILD = ROOT / "sanafe_tpu_torch" / "build" / "variants"
NO_ADDS = ("if (s_count > 0) consume(slot);", "")
NO_COPIES = ("r < count; r += kCopiers", "r < 0; r += kCopiers")
VARIANTS = {
    "as_built": [],
    "no_adds": [NO_ADDS],
    "no_copies": [NO_COPIES],
    "neither": [NO_ADDS, NO_COPIES],
    "producer_only": [
        ("  if (tid >= kThreads - kWarp) {\n    // --- the producer warp",
         "  if (tid < kThreads - kWarp) return;\n"
         "  if (tid >= kThreads - kWarp) {\n    // --- the producer warp"),
        ("if (j >= K) mbar_wait(&empty[slot], ((j / K) - 1) & 1);", ""),
    ],
    "four_copiers": [("return S >= 16 ? 4 : 8;", "return 4;")],
    "stage_unrolled": [
        ("#pragma unroll 1\n    for (int r0 = 0; r0 < kRows;",
         "#pragma unroll\n    for (int r0 = 0; r0 < kRows;")],
    "branch_a_row": [("all &= m[q] == mine_all;", "all = false;")],
}
SAMPLES = (1, 16, 64)


def build() -> dict:
    """One nvcc a variant, all started together; returns name -> CDLL."""
    from sanafe_tpu_torch.ops import cuda_build, delivery

    text = SOURCE.read_text()
    BUILD.mkdir(parents=True, exist_ok=True)
    running = []
    for name, edits in VARIANTS.items():
        patched = text
        for old, new in edits:
            if old not in patched:
                raise SystemExit(f"{name}: {old!r} is not in {SOURCE.name}")
            patched = patched.replace(old, new)
        src = BUILD / f"{name}.cu"
        src.write_text(patched)
        lib = BUILD / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
               str(src)]
        running.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ours = delivery._batch_library()
    libs = {}
    for name, lib_path, proc in running:
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{err[-4000:]}")
        report = [line.strip() for line in (out + err).splitlines()
                  if "registers" in line or "spill" in line]
        print(f"batch_variants: {name} build: {' | '.join(report)}",
              flush=True)
        lib = ctypes.CDLL(str(lib_path))
        for fn in ("sanafe_delivery_batch_launch",
                   "sanafe_delivery_batch_smem",
                   "sanafe_delivery_batch_error_string"):
            getattr(lib, fn).restype = getattr(ours, fn).restype
            getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("batch_delivery_variants: no CUDA device", file=sys.stderr)
        return 2
    import sanafe_tpu_torch as st
    from sanafe_tpu_torch.compile import compile_chip
    from sanafe_tpu_torch.ops import delivery
    from sanafe_tpu_torch.ops.step import make_device_program

    card = chip_smoke.card_line()
    libs = build()
    compiled = compile_chip(*chip_smoke.random_chip(st, **chip_smoke.FULL))
    blk = make_device_program(compiled, "cuda", torch.float32).block
    dblk = chip_smoke.dense_of(blk)  # the program holds the live rows alone
    lists = {"live": blk.live_rows,
             "every": delivery.every_row_live(blk.n_blocks, blk.tile,
                                              "cuda")}
    fired = torch.zeros(blk.n_pad, device="cuda")
    fired[: compiled.n_neurons] = 1.0
    fired = fired.view(blk.n_tiles, blk.tile)
    # the plain version takes the dense blocks, the kernel the listed rows
    shared = (dblk.weights, dblk.arrivals, blk.src_tiles, blk.dest_offsets,
              blk.max_blocks_per_dest)
    ours = delivery._batch_library
    for kind, rows in lists.items():
        held = delivery.compact_blocks(dblk.weights, dblk.arrivals, rows)[1:]
        for samples in SAMPLES:
            x = fired.expand(samples, -1, -1).contiguous()
            times = {}
            for name, lib in libs.items():
                delivery._batch_library = lambda lib=lib: lib
                try:
                    def run():
                        return delivery.delivery_batch_kernel(
                            x, *held, *shared[2:], rows)
                    if name == "as_built":
                        ref = delivery.delivery_batch_plain(x, *shared)
                        got = run()
                        if not (chip_smoke.same_bits(got[0], ref[0])
                                and torch.equal(got[1], ref[1])):
                            raise SystemExit(f"{kind} B={samples}: the "
                                             "kernel differs from "
                                             "delivery_batch_plain")
                        del ref, got
                    times[name] = chip_smoke.queued_ms(
                        run, 5 if kind == "every" else 20)
                finally:
                    delivery._batch_library = ours
            print(f"batch_variants: {kind} rows, every neuron fired, "
                  f"B={samples}: ms (queued) {times} | {card}", flush=True)
            del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
