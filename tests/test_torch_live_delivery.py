"""Block delivery over the live-row list, the step scan's delivery on the
card.

``ops/delivery.py:delivery_live_plain`` is the plain version of the
single-sample delivery kernel (``csrc/delivery_kernel.cu``) in its order:
for each destination tile, one accumulator per column from +0.0, adding the
listed live rows that fired in list order (blocks ascending, rows ascending
within a block). It is held here:

- to ``delivery_plain`` and to sanafe_tpu's activity-gated Pallas kernel
  (``make_delivery_fn(..., interpret=True)``) and its einsum + sorted
  segment-sum path (as ``tests/test_torch_delivery.py`` runs them), on the
  random 1024-neuron chip and seeded fired patterns: exactly on the chip's
  integer weights, within rtol 1e-12 in float64 on seeded real weights
  (the products and the segment sum group the terms otherwise); arrivals
  equal to the count product's ``> 0``;
- to numpy loops, bit for bit, on seeded blocks of real weights with -0.0
  cells, NaN and inf rows and rows whose weights cancel to zero beside an
  arrival bit, at tiles 8, 64 and 256 in float32 and float64: a loop over
  a numpy list of the live rows in list order, and a loop over every fired
  row in block order (a row left out adds +-0.0 and changes no bit);
- to ``delivery_batch_plain`` at one sample on integer weights.

A kernel-delivery program (``use_kernel=True``; the CPU runs the plain
version) carries ``build_live_rows`` of its blocks and the kernel's
operands checked once (``plan_delivery``), whose entries are the list in
list order; ``tests/test_torch_scan.py`` checks that its scans go through
it, and ``tests/test_torch_parallel.py`` each rank's program on a mesh.

The kernel itself is held to ``delivery_live_plain`` and to
``delivery_batch_kernel`` at one sample on the card
(``tests/test_torch_cuda.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from sanafe_tpu_torch.ops.delivery import (
    LiveRows,
    build_live_rows,
    delivery_batch_plain,
    delivery_kernel,
    delivery_live_plain,
    delivery_plain,
    live_entries,
    pack_arrival_plane,
)
from sanafe_tpu_torch.ops.step import BlockDelivery, build_block_delivery
from sanafe_tpu_torch.ops.step import make_device_program

from test_torch_chips import compile_both
from test_torch_delivery import PATTERNS, fired_pattern, jax_deliveries

DTYPES = {"f32": (torch.float32, np.float32), "f64": (torch.float64,
                                                      np.float64)}


def live_args(blk, x, weights=None, counts=None):
    """``delivery_kernel``'s arguments for the fired plane ``x`` (0/1,
    [n_tiles, tile]), over ``weights`` / ``counts`` (default the block's),
    with ``build_live_rows`` of them."""
    weights = blk.weights if weights is None else weights
    plane = pack_arrival_plane(blk.counts if counts is None else counts)
    return (x, weights, plane, blk.src_tiles, blk.dest_offsets,
            blk.max_blocks_per_dest, build_live_rows(weights, plane))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


@pytest.mark.parametrize("weights_kind", ["chip", "real"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_live_plain_matches_jax(pattern, weights_kind):
    from sanafe_tpu.ops.step import build_block_delivery as jax_build

    jax_compiled, port_compiled = compile_both("random1024")
    jb = jax_build(jax_compiled)
    pb = build_block_delivery(port_compiled, torch.float64, "cpu")
    weights = np.array(jb.weights, dtype=np.float64)
    if weights_kind == "real":
        # real weights on the chip's cells: the live rows are the chip's
        rng = np.random.default_rng(1)
        weights = rng.standard_normal(weights.shape) * (
            np.asarray(jb.counts) > 0)
    n = jax_compiled.n_neurons
    x = np.zeros(jb.n_pad)
    x[:n] = fired_pattern(n, jb.tile, pattern)
    x_tiles = x.reshape(jb.n_tiles, jb.tile)

    pallas, einsum, counts = jax_deliveries(jb, x_tiles, weights)
    args = live_args(pb, torch.from_numpy(x_tiles),
                     torch.from_numpy(weights))
    cur, arrived = delivery_live_plain(*args)
    ref_cur, ref_cnt = delivery_plain(
        args[0], args[1], pb.counts, pb.src_tiles, pb.dest_offsets,
        pb.max_blocks_per_dest)
    assert cur.dtype == torch.float64 and arrived.dtype == torch.bool
    np.testing.assert_array_equal(arrived.numpy(), counts > 0)
    assert torch.equal(arrived, ref_cnt > 0)
    assert 0 < args[-1].count < pb.weights.shape[0] * pb.tile
    if weights_kind == "chip":
        for want in (pallas, einsum, ref_cur.numpy()):
            np.testing.assert_array_equal(cur.numpy(), want)
    else:
        for want in (pallas, einsum, ref_cur.numpy()):
            np.testing.assert_allclose(cur.numpy(), want, rtol=1e-12,
                                       atol=1e-12)
    if pattern == "none":
        assert not cur.any() and not arrived.any()


def special_blocks(tile: int, np_dtype, seed: int = 4):
    """Seeded real-weight blocks of tile ``tile`` on 5 tiles: a quarter of
    the cells hold an edge; -0.0 cells without an edge (a row of them alone
    stays out of the list); a NaN row and an inf row; a row whose weights
    cancel to zero beside an arrival bit; destination tile 1 with no
    block. Returns (BlockDelivery, weights, counts) as numpy."""
    rng = np.random.default_rng(seed)
    n_tiles = 5
    pairs = [(d, s) for d in range(n_tiles) for s in range(n_tiles)
             if d != 1 and (rng.random() < 0.6 or s == d)]
    dest = np.array([d for d, _ in pairs], dtype=np.int32)
    src = np.array([s for _, s in pairs], dtype=np.int32)
    shape = (len(pairs), tile, tile)
    counts = (rng.random(shape) < 0.25).astype(np.int8)
    weights = (rng.uniform(-2.0, 2.0, shape) * counts).astype(np_dtype)
    weights[(counts == 0) & (rng.random(shape) < 0.3)] = -0.0
    offsets = np.searchsorted(dest, np.arange(n_tiles + 1)).astype(np.int32)
    weights[0, 1] = np.nan  # destination tile 0
    weights[offsets[3], 2] = -np.inf
    weights[offsets[4], 2] = np.inf
    counts[2, 0] = 0
    weights[2, 0] = 0.0
    counts[2, 0, 1] = 1  # an arrival bit alone keeps the row live
    weights[2, 0, 1] = 0.0
    counts[3, 1] = 0
    weights[3, 1] = -0.0  # a row of -0.0 alone stays out
    blk = BlockDelivery(
        tile=tile, n_tiles=n_tiles, n_pad=n_tiles * tile,
        src_tiles=torch.from_numpy(src), dest_tiles=torch.from_numpy(dest),
        weights=torch.from_numpy(weights),
        counts=torch.from_numpy(counts),
        dest_offsets=torch.from_numpy(offsets),
        max_blocks_per_dest=int(np.diff(offsets).max()))
    return blk, weights, counts


def numpy_loop(weights, counts, blk, fired, rows):
    """For each destination tile, an accumulator per column from +0.0
    adding ``rows(b)`` of each of its blocks b, ascending, where the row
    fired, and the OR of their edges."""
    tile = blk.tile
    src = blk.src_tiles.numpy()
    offsets = blk.dest_offsets.numpy()
    cur = np.zeros((blk.n_tiles, tile), dtype=weights.dtype)
    arrived = np.zeros((blk.n_tiles, tile), dtype=bool)
    for d in range(blk.n_tiles):
        for b in range(offsets[d], offsets[d + 1]):
            for i in rows(b):
                if fired[src[b], i]:
                    cur[d] = cur[d] + weights[b, i]
                    arrived[d] |= counts[b, i] > 0
    return cur, arrived


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile", [8, 64, 256])
def test_live_plain_matches_numpy_loop(tile, dtype):
    blk, weights, counts = special_blocks(tile, DTYPES[dtype][1])
    rng = np.random.default_rng(tile)
    fired = rng.random((blk.n_tiles, tile)) < 0.5
    fired[2] = False
    src = blk.src_tiles.numpy()
    offsets = blk.dest_offsets.numpy()
    fired[src[0], 1] = True  # the NaN and inf rows fire
    fired[src[offsets[3]], 2] = fired[src[offsets[4]], 2] = True
    x = torch.from_numpy(fired.astype(weights.dtype))
    args = live_args(blk, x)
    live = args[-1]
    cur, arrived = delivery_live_plain(*args)
    # the list in numpy: a weight that is not +-0.0 (NaN counts) or an edge
    live_np = np.any(weights != 0, axis=2) | np.any(counts > 0, axis=2)
    assert not live_np[3, 1] and live_np[2, 0] and live_np[0, 1]
    listed = live.offsets.numpy()
    for b in range(weights.shape[0]):
        np.testing.assert_array_equal(
            live.rows[listed[b]:listed[b + 1]].numpy(),
            np.nonzero(live_np[b])[0])
    in_list = numpy_loop(weights, counts, blk, fired,
                         lambda b: np.nonzero(live_np[b])[0])
    every_row = numpy_loop(weights, counts, blk, fired,
                           lambda b: range(tile))
    for want_cur, want_arrived in (in_list, every_row):
        assert same_bits(cur, torch.from_numpy(want_cur))
        np.testing.assert_array_equal(arrived.numpy(), want_arrived)
    assert torch.isnan(cur).any() and torch.isinf(cur).any()
    assert not arrived[1].any() and not cur[1].any()
    # sums that reach zero stay +0.0
    assert not torch.signbit(cur[cur == 0]).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pattern", PATTERNS)
def test_live_plain_matches_batch_plain_at_one_sample(pattern, dtype):
    """On the chip's integer weights the list's order and the batched
    plain version's products agree bit for bit."""
    torch_dtype = DTYPES[dtype][0]
    _, port_compiled = compile_both("random1024")
    pb = build_block_delivery(port_compiled, torch_dtype, "cpu")
    n = port_compiled.n_neurons
    x = torch.zeros(pb.n_pad, dtype=torch_dtype)
    x[:n] = torch.from_numpy(fired_pattern(n, pb.tile, pattern))
    args = live_args(pb, x.view(pb.n_tiles, pb.tile))
    cur, arrived = delivery_live_plain(*args)
    batch_cur, batch_arrived = delivery_batch_plain(args[0][None],
                                                    *args[1:])
    assert same_bits(cur, batch_cur[0])
    assert torch.equal(arrived, batch_arrived[0])
    kernel_cur, kernel_arrived = delivery_kernel(*args)  # CPU: the plain
    assert same_bits(cur, kernel_cur) and torch.equal(arrived,
                                                      kernel_arrived)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["random1024", "random2048", "stochastic",
                                  "example"])
def test_kernel_program_carries_live_rows(name, dtype):
    """``make_device_program(use_kernel=True)`` builds the list once from
    its blocks, beside the packed arrival plane, and checks the kernel's
    operands once: the plan's entries are the list in list order, each
    destination tile's contiguous. A program without the kernel has no
    list."""
    torch_dtype = DTYPES[dtype][0]
    _, port_compiled = compile_both(name)
    prog = make_device_program(port_compiled, "cpu", torch_dtype,
                               use_kernel=True)
    blk = prog.block
    assert prog.kernel_delivery and blk.counts is None
    plan = blk.plan
    live = plan.live_rows
    want = build_live_rows(blk.weights, blk.arrivals)
    assert isinstance(live, LiveRows) and live.count == want.count > 0
    assert torch.equal(live.rows, want.rows)
    assert torch.equal(live.offsets, want.offsets)
    assert plan.launch is None
    assert plan.weights is blk.weights and plan.arrivals is blk.arrivals
    assert plan.shape == (blk.n_tiles, blk.tile)
    entries, tile_entries = live_entries(live, blk.src_tiles,
                                         blk.dest_offsets, blk.tile)
    assert torch.equal(plan.entries, entries)
    assert torch.equal(plan.tile_entries, tile_entries)
    # entry by entry: block b's live row i is (b * tile + i, its source
    # neuron), in list order, and destination tile d's entries are those
    # of its blocks
    offsets = live.offsets.numpy()
    src = blk.src_tiles.numpy()
    expect = [(b * blk.tile + int(i), src[b] * blk.tile + int(i))
              for b in range(len(src))
              for i in live.rows[offsets[b]:offsets[b + 1]].numpy()]
    assert entries.tolist() == [list(e) for e in expect]
    dest = blk.dest_offsets.numpy()
    np.testing.assert_array_equal(tile_entries.numpy(), offsets[dest])
    plain = make_device_program(port_compiled, "cpu", torch_dtype)
    assert not plain.kernel_delivery
    assert plain.block.plan is None


def test_delivery_kernel_refuses_other_devices():
    """Neither the wrapper nor the plan falls back: a tensor on a device
    that is neither the CPU nor CUDA raises, and so does a list whose row
    count is not its offsets' end."""
    blk, weights, counts = special_blocks(8, np.float32)
    x = torch.ones((blk.n_tiles, blk.tile))
    args = live_args(blk, x)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args[:-1]]
    with pytest.raises(ValueError, match="unsupported device"):
        delivery_kernel(*meta, args[-1])
    from sanafe_tpu_torch.ops.delivery import plan_delivery

    with pytest.raises(ValueError, match="unsupported device"):
        plan_delivery(*meta[1:], args[-1])
    # a list whose count disagrees with its offsets
    short = args[-1]._replace(count=args[-1].count - 1)
    with pytest.raises(ValueError, match="live_rows lists"):
        delivery_kernel(*args[:-1], short)

