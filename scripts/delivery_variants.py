#!/usr/bin/env python3
"""What each part of the single-sample delivery kernel costs on the card.

    python3 scripts/delivery_variants.py            # on a card

Builds patched copies of ``sanafe_tpu_torch/csrc/delivery_kernel.cu``
(``VARIANTS``: each a list of (text, replacement) pairs; the script stops
if a text is gone from the source) into ``sanafe_tpu_torch/build/variants/``
with the package's flags, prints each build's registers and spills, and
times each through the package's wrapper (its library swapped in), its
launches queued ahead (``chip_smoke.queued_ms``), on the live rows of
``chip_smoke.py``'s chips: DVS-gesture's edges all as blocks in float32
with a seeded 7% and all of its neurons fired, ``full`` in float32 and
``mid`` in float64 with every neuron fired. The kernel as built and each
variant that does all the work is first held bit for bit to
``delivery_live_plain``; the variants that leave out work (``LOSSY``) give
wrong sums and are only timed:

- ``no_adds``: the adder warps wait and free each stage without adding;
- ``no_copies``: the copier warps copy nothing (the adders add stale
  shared memory);
- ``producer_only``: the producers list every stage without waiting for
  free slots, and the other warps leave at once;
- ``one_producer``: one producer warp walks every round (four as built);
- ``cp_async_copies``: the rows copied by cp.async, a 16-byte chunk a
  lane, a row a warp (a bulk copy a row a lane as built);
- ``two_copiers``, ``four_copiers``: 2 or 4 copier warps (8 as built);
- ``batch_four``: the adders load four rows at a time (eight as built);
- ``more_slices``: rows cut into column slices up to 256 CTAs (128 as
  built);
- ``test_wait``: mbarrier waits that poll (``test_wait``) instead of
  suspending between tests (``try_wait``);
- ``rows_16``: stages of 16 rows, a ring up to 16 deep (32 and 8 as
  built);
- ``deep_ring``: a ring up to 16 deep (8 as built);
- ``lanes_16``: 16 entries a producer lane a round (8 as built).

Prints the card's name and power limit on every line.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the chips' recipes, queued_ms)

CSRC = ROOT / "sanafe_tpu_torch" / "csrc"
SOURCE = CSRC / "delivery_kernel.cu"
BUILD = ROOT / "sanafe_tpu_torch" / "build" / "variants"
# an mbarrier wait that polls (test_wait) where the kernel's suspends the
# thread between tests (try_wait)
TEST_WAIT = """__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\\n\\t.reg .pred p;\\n\\t"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n\\t"
        "selp.u32 %0, 1, 0, p;\\n\\t}"
        : "=r"(done)
        : "r"(sanafe::smem_addr(bar)), "r"(parity)
        : "memory");
  }
}"""
# the copier warps' bulk copies as built, from the first test of the
# arrival words' kind to the copies
_TEXT = SOURCE.read_text()
_FIRST = "      if (!bulk_words) {\n"
_LAST = "        if (bulk_words) bulk_copy(a_dst, a_src, 4 * AW, &full[slot]);\n      }\n"
BULK = _TEXT[_TEXT.index(_FIRST):_TEXT.index(_LAST) + len(_LAST)]
# in their place, cp.async: warp w copies rows w, w + kCopiers, ..., a lane
# a 16-byte chunk of the row's slice and lanes below AW an arrival word
CP_ASYNC = """      for (int rr = cw; rr < count; rr += kCopiers) {
        const size_t row = static_cast<size_t>(row_of[slot * kRows + rr]);
        unsigned char* to = ring_w + static_cast<size_t>(slot * kRows + rr) *
                                         row_bytes;
        for (int c = lane; c < SC; c += kWarp) {
          cp_async<16>(to + 16 * c, w + row * tile + col0 + c * kVec);
        }
        if (lane < AW) {
          cp_async<4>(ring_a + static_cast<size_t>(slot * kRows + rr) * AW +
                          lane,
                      arrive + row * p.row_words + w0 + lane);
        }
      }
      cp_async_arrive(&full[slot]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[slot]);
"""
VARIANTS = {
    "as_built": [],
    "no_adds": [("      for (int r0 = 0; r0 < count; r0 += kBatchRows) {",
                 "      for (int r0 = 0; r0 < 0; r0 += kBatchRows) {")],
    "no_copies": [("      if (copies) {\n        bulk_copy(",
                   "      if (false) {\n        bulk_copy("),
                  ("mbar_arrive_expect_tx(&full[slot], mine * row_tx);",
                   "mbar_arrive_expect_tx(&full[slot], 0);")],
    "producer_only": [
        ("  if (warp >= p.adders + kCopiers) {",
         "  if (warp < p.adders + kCopiers) return;\n"
         "  if (warp >= p.adders + kCopiers) {"),
        ("if (j >= K) mbar_wait(&empty[slot], ((j / K) - 1) & 1);", ""),
    ],
    "one_producer": [("constexpr int kProducers = 4;",
                      "constexpr int kProducers = 1;")],
    "cp_async_copies": [(BULK, CP_ASYNC)],
    "two_copiers": [("constexpr int kCopiers = 8;",
                     "constexpr int kCopiers = 2;")],
    "four_copiers": [("constexpr int kCopiers = 8;",
                      "constexpr int kCopiers = 4;")],
    "batch_four": [("constexpr int kBatchRows = 8;",
                    "constexpr int kBatchRows = 4;")],
    "more_slices": [("constexpr int kMinCtas = 128;",
                     "constexpr int kMinCtas = 256;")],
    "test_wait": [("using sanafe::mbar_wait;", TEST_WAIT)],
    "rows_16": [("constexpr int kRows = 32; ", "constexpr int kRows = 16; "),
                ("constexpr int kMaxStages = 8;",
                 "constexpr int kMaxStages = 16;")],
    "deep_ring": [("constexpr int kMaxStages = 8;",
                   "constexpr int kMaxStages = 16;")],
    "lanes_16": [("constexpr int kPerLane = 8; ",
                  "constexpr int kPerLane = 16; "),
                 ("constexpr int kQueue = 512; ",
                  "constexpr int kQueue = 1024; ")],
}
# the variants that leave out work: timed, not held to the plain version
LOSSY = ("no_adds", "no_copies", "producer_only")


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
        src = BUILD / f"single_{name}.cu"
        src.write_text(patched)
        lib = BUILD / f"libsingle_{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(lib), str(src)]
        running.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ours = delivery._library()
    libs = {}
    for name, lib_path, proc in running:
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{err[-4000:]}")
        report = [line.strip() for line in (out + err).splitlines()
                  if "registers" in line or "spill" in line]
        print(f"single_variants: {name} build: {' | '.join(report)}",
              flush=True)
        lib = ctypes.CDLL(str(lib_path))
        for fn in ("sanafe_delivery_launch", "sanafe_delivery_smem",
                   "sanafe_delivery_error_string"):
            getattr(lib, fn).restype = getattr(ours, fn).restype
            getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
        libs[name] = lib
    return libs


def fired_plane(blk, n: int, share: float, dtype):
    """A seeded plane with ``share`` of the ``n`` neurons fired."""
    fired = np.zeros(blk.n_pad, dtype=bool)
    fired[:n] = np.random.default_rng(7).random(n) < share
    return torch.from_numpy(fired).to("cuda", dtype).view(blk.n_tiles,
                                                          blk.tile)


def main() -> int:
    if not torch.cuda.is_available():
        print("delivery_variants: no CUDA device", file=sys.stderr)
        return 2
    import sanafe_tpu_torch as st
    from sanafe_tpu_torch.compile import compile_chip
    from sanafe_tpu_torch.ops import delivery
    from sanafe_tpu_torch.ops.step import build_block_delivery

    card = chip_smoke.card_line()
    libs = build()
    cases = (
        ("dvs", lambda: chip_smoke.dvs_chip(st), torch.float32,
         (0.07, 0.25, 1.0)),
        ("full", lambda: chip_smoke.random_chip(st, **chip_smoke.FULL),
         torch.float32, (1.0,)),
        ("mid", lambda: chip_smoke.random_chip(st, **chip_smoke.MID),
         torch.float64, (1.0,)),
    )
    ours = delivery._library
    for chip, make, dtype, shares in cases:
        compiled = compile_chip(*make())
        blk = build_block_delivery(compiled, dtype, "cuda")
        plane = delivery.pack_arrival_plane(blk.counts)
        live = delivery.build_live_rows(blk.weights, plane)
        args = (blk.weights, plane, blk.src_tiles, blk.dest_offsets,
                blk.max_blocks_per_dest, live)
        for share in shares:
            x = fired_plane(blk, compiled.n_neurons, share, dtype)
            times = {}
            for name, lib in libs.items():
                delivery._library = lambda lib=lib: lib
                try:
                    plan = delivery.plan_delivery(*args)
                    if name not in LOSSY:
                        ref = delivery.delivery_live_plain(x, *args)
                        got = delivery.delivery_launch(x, plan)
                        if not (chip_smoke.same_bits(got[0], ref[0])
                                and torch.equal(got[1], ref[1])):
                            raise SystemExit(f"{chip} {share}: {name} "
                                             "differs from "
                                             "delivery_live_plain")
                        del ref, got
                    times[name] = chip_smoke.queued_ms(
                        lambda: delivery.delivery_launch(x, plan), 20)
                finally:
                    delivery._library = ours
            print(f"single_variants: {chip} {str(dtype)[6:]} "
                  f"{blk.n_tiles} tiles, {live.count} live rows, "
                  f"{int(x.count_nonzero())} fired: ms (queued) {times} | "
                  f"{card}", flush=True)
        del blk, plane, live, args, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
