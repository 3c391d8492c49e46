"""The live-row lists the sample-batched delivery kernel reads.

``ops/delivery.py:build_live_rows`` lists, block by block in ascending
order, the rows that hold a weight other than +-0.0 (a NaN or inf weight
counts) or an arrival bit; with per-sample weights or arrival planes, the
union over the samples. It is held here to a numpy reference written as
loops:

- seeded sparse blocks with -0.0 cells (their rows stay out), a NaN and an
  inf cell, rows live by an arrival bit alone, and all-zero blocks, at
  tiles 8, 64 and 256, float32 and float64, with shared or per-sample
  weights and arrival planes;
- ``every_row_live``, the list of every row;
- ``ParameterSweep``'s list on ``tests/test_torch_chips.py``'s random chip
  (a kernel-delivery program), with ``block_weights`` and ``block_counts``
  swept per sample, against sanafe_tpu's block arrays and the overrides.

The list is a program input, not a name a user may override. The kernel
itself is held to its plain version on the card
(``tests/test_torch_cuda.py``).
"""

import functools

import numpy as np
import pytest
import torch

import sanafe_tpu as sf
import sanafe_tpu_torch as st
from sanafe_tpu.batch import ParameterSweep as JaxSweep
from sanafe_tpu.batch import expand_group_values as jax_expand
from sanafe_tpu_torch import batch as port_batch
from sanafe_tpu_torch.ops import step as port_step
from sanafe_tpu_torch.ops.delivery import (
    LiveRows,
    build_live_rows,
    every_row_live,
    pack_arrival_plane,
)

from test_torch_chips import random_chip


def live_reference(weights: np.ndarray, counts: np.ndarray):
    """Row by row: live where a weight is not +-0.0 or an edge count is
    positive, in any sample. Returns (rows, offsets) as numpy arrays."""
    if weights.ndim == 3:
        weights = weights[None]
    if counts.ndim == 3:
        counts = counts[None]
    n_blocks, tile = weights.shape[1], weights.shape[2]
    rows, offsets = [], [0]
    for k in range(n_blocks):
        for i in range(tile):
            live = False
            for w in weights:  # NaN != 0 holds: a NaN weight counts
                live |= bool(np.any(w[k, i] != 0))
            for c in counts:
                live |= bool(np.any(c[k, i] > 0))
            if live:
                rows.append(i)
        offsets.append(len(rows))
    return np.asarray(rows, dtype=np.uint8), np.asarray(offsets, np.int32)


def assert_lists(live: LiveRows, rows: np.ndarray, offsets: np.ndarray):
    assert live.count == len(rows)
    assert live.rows.dtype == torch.uint8 and live.rows.dim() == 1
    assert live.rows.numel() % 16 == 0 and live.rows.numel() >= 16
    assert live.offsets.dtype == torch.int32
    np.testing.assert_array_equal(live.offsets.numpy(), offsets)
    np.testing.assert_array_equal(live.rows[: live.count].numpy(), rows)
    assert not live.rows[live.count:].any()  # zero padding


def _blocks(rng, n_blocks, tile, dtype):
    """Seeded sparse blocks: a few rows with integer or real weights, -0.0
    cells alone in their rows, rows with arrivals only, a NaN and an inf
    cell, and all-zero blocks."""
    w = np.zeros((n_blocks, tile, tile))
    counts = np.zeros((n_blocks, tile, tile), dtype=np.int8)
    for k in range(n_blocks):
        if k % 4 == 3:
            continue  # an all-zero block
        for i in rng.choice(tile, size=max(1, tile // 8), replace=False):
            j = rng.choice(tile, size=2, replace=False)
            w[k, i, j] = rng.uniform(-2, 2, size=2)
            counts[k, i, j] = 1
        neg = rng.integers(tile)
        if not counts[k, neg].any():
            w[k, neg, rng.integers(tile)] = -0.0  # not live
        only = rng.integers(tile)
        if not w[k, only].any():
            counts[k, only, rng.integers(tile)] = 2  # live by its arrival
    w[0, tile - 1, 0] = np.nan
    w[n_blocks - 2, 0, tile - 1] = np.inf
    return w.astype(np.float32 if dtype == torch.float32 else np.float64), \
        counts


@pytest.mark.parametrize("layout", ["shared", "weights", "arrivals", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile", [8, 64, 256])
def test_build_live_rows_matches_numpy(tile, dtype, layout):
    rng = np.random.default_rng(tile + len(layout))
    n_blocks, samples = 9, 3
    w, counts = _blocks(rng, n_blocks, tile, dtype)
    if layout in ("weights", "both"):
        # sample b keeps the weights of every (b + 1)-th row; sample 2's
        # last block gets a row of its own
        keep = np.stack([np.arange(tile) % (b + 1) == 0
                         for b in range(samples)])
        w = w[None] * keep[:, None, :, None]
        w[2, -1, 1, 1] = 3.0
    if layout in ("arrivals", "both"):
        counts = np.stack([counts * (np.arange(tile) % (b + 2) == 0)[
            None, :, None] for b in range(samples)]).astype(np.int8)
    plane = torch.from_numpy(counts)
    plane = (torch.stack([pack_arrival_plane(c) for c in plane])
             if plane.dim() == 4 else pack_arrival_plane(plane))
    live = build_live_rows(torch.from_numpy(w).to(dtype), plane)
    assert_lists(live, *live_reference(w, counts))
    assert 0 < live.count < n_blocks * tile


def test_every_row_live():
    live = every_row_live(5, 8, "cpu")
    assert_lists(live, np.tile(np.arange(8, dtype=np.uint8), 5),
                 np.arange(6, dtype=np.int32) * 8)
    empty = build_live_rows(torch.zeros((3, 8, 8)),
                            torch.zeros((3, 8, 1), dtype=torch.int32))
    assert_lists(empty, np.zeros(0, np.uint8), np.zeros(4, np.int32))


@pytest.mark.parametrize("swept", ["threshold", "block_weights",
                                   "block_counts"])
def test_sweep_live_rows_match_overrides(monkeypatch, swept):
    """A kernel-delivery sweep lists the rows live in any sample of its
    (possibly overridden) blocks, in sanafe_tpu's block layout."""
    monkeypatch.setattr(port_batch, "make_device_program", functools.partial(
        port_step.make_device_program, use_kernel=True))
    kwargs = dict(cores=16, neurons_per_core=64)
    arch, net = random_chip(sf, **kwargs)
    jchip = sf.SpikingChip(arch)
    jchip.load(net)
    arch, net = random_chip(st, **kwargs)
    pchip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    pchip.load(net)
    over = jax_expand(jchip.compiled, "threshold",
                      {"pop": np.array([32.0, 64.0, 200.0])})
    jprog = JaxSweep(jchip, {"threshold": over}).prog
    weights = np.asarray(jprog.arrays["block_weights"])
    counts = np.asarray(jprog.arrays["block_counts"])
    overrides = {"threshold": over}
    if swept == "block_weights":
        # a zero scale empties sample 0's blocks; the union keeps the rest
        weights = weights[None] * np.array([0.0, 0.25, 1.0])[
            :, None, None, None]
        overrides = {swept: weights}
    elif swept == "block_counts":
        keep = np.stack([np.arange(counts.shape[1]) % k == 0
                         for k in (2, 3, 5)])
        counts = counts[None] * keep[:, None, :, None]
        weights = weights * 0.0  # live rows come from the counts alone
        overrides = {swept: counts, "block_weights": weights[None].repeat(
            3, axis=0)}
    sweep = st.ParameterSweep(pchip, overrides)
    assert "block_batch_plan" not in sweep.prog.arrays
    live = sweep.arrays["block_batch_plan"].live_rows
    rows, offsets = live_reference(weights, counts)
    assert_lists(live, rows, offsets)
    assert 0 < live.count < counts.shape[-3] * counts.shape[-2]
    with pytest.raises(KeyError):
        st.ParameterSweep(pchip, {"block_live_rows": np.zeros((2, 3))})
