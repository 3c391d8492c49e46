"""Activity-gated block-dense spike delivery.

Counterpart of ``sanafe_tpu/ops/pallas_delivery.py`` and of the delivery
part of ``sanafe_tpu/ops/step.py:_block_deliver``. Per timestep, for each
destination tile, the sum over its blocks (sorted dest-major, as
``build_block_delivery`` gives them) of ``x[src_tile] @ W[block]``, where
``x`` is the 0/1 fired vector cut into ``[n_tiles, tile]``; and in the same
pass the reference's "message arrived" condition: whether any fired row of
any of the tile's blocks holds an edge into the column.

``delivery_plain`` is the einsum + sorted segment sum and the int8 count
product of sanafe_tpu (``ops/step.py:1580-1608``) in PyTorch, for any
device; its ``cnt > 0`` is the arrival condition. ``delivery_kernel`` is the
wrapper of ``csrc/delivery_kernel.cu``. The kernel reads only the live rows
(``build_live_rows``: a row with a weight that is not +-0.0 or an arrival
bit; every other row would add +0.0, which changes no bit of a sum from
+0.0) that fired, and one bit a cell where the step needs one bit: instead
of the int8 counts it takes the packed arrival plane
``pack_arrival_plane(counts)`` (``counts > 0``, 32 columns a word) and ORs
it over those rows. Each column adds the fired live rows in list order
(blocks ascending, rows ascending within a block) from +0.0.

The kernels hold only the listed rows: weights ``[count, tile]`` and
arrival words ``[count, words]``, row ``r`` being the list's ``r``-th
entry (``compact_blocks`` takes them out of dense blocks; a program builds
them straight from its edges, ``ops/step.py:build_block_delivery``).
``delivery_live_plain`` is the kernel's sum in PyTorch over the dense
blocks, the plain version the compact path is held to; the wrappers' path
for CPU tensors runs the same sum over the compact rows. A program checks
the operands once (``plan_delivery``) and each step launches
(``delivery_launch``).

Where the live rows hold few edges each (TCAD'25's largest random network:
4 edges in a row of 256 columns) the same kernel walks the cells instead
(``DeliveryCells``: each destination neuron's edge cells in source order,
a source neuron and a weight each, ``build_delivery_cells``), in the same
order of adds, so bit for bit the same sums (``delivery_cells_plain``). The
rows' kernel reads only the rows whose source fired, the cells' kernel
every cell, each destination's as one chain of adds: a program holds
whichever the kernel's measured cost (``delivery_us``) makes faster, first
with every neuron firing (``cells_faster``), and once more at the share
that fired in its first steps (``ops/step.py:settle_delivery``); it plans
them once (``plan_delivery_cells``).

``delivery_batch_kernel`` (``csrc/delivery_batch_kernel.cu``) is the same
delivery for B fired vectors at once, the sample axis of ``ParameterSweep``
(sanafe_tpu's ``jax.vmap`` of the Pallas kernel): each live weight row
fired in any sample is read once and added into every sample that fired
it, in the same order. Its plain version over the dense blocks is
``delivery_batch_plain``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .cuda_build import DELIVERY, DELIVERY_BATCH, load

# a tile is at most this many neurons (the live-row lists hold row indices
# as bytes), and a multiple of 4 (rows are read 16 bytes at a time)
MAX_TILE = 256
# destinations a slice of the cell layout (a warp's lanes, one each), and
# the consecutive cells of a destination that lie together (a 16-byte load
# of their sources)
CELL_SLICE = 32
CELL_GROUP = 4
# The kernel's time a step on an H100 80GB HBM3 at 700 W, fitted to the
# sweep of scripts/delivery_crossover.py (PERF.md §6: four chips at eight
# fired shares; it picks the faster path at 30 of the 32, and the path it
# picks at the other two takes at most 1.16x the other's). Over the
# live rows: ROWS_US, ROW_ENTRY_NS a live row of a destination tile (each
# tile's CTAs walk its list) and the fired rows' bytes at ROWS_GB_S, a
# share of it where fewer than ROWS_TILES destination tiles leave SMs idle.
# Over the cells: CELLS_US and the larger of the cells' bytes at CELLS_GB_S
# and the longest destination's cells at CELL_CHAIN_NS a cell (a
# destination's adds are one thread's chain).
ROWS_US = 2.2
ROW_ENTRY_NS = 4.7
ROWS_GB_S = 2900.0
ROWS_TILES = 132
CELLS_US = 6.5
CELLS_GB_S = 1850.0
CELL_CHAIN_NS = 80.0


def sorted_segment_sum(values: torch.Tensor, dest_offsets: torch.Tensor,
                       max_per_segment: int) -> torch.Tensor:
    """Sum the rows of ``values`` (sorted by segment) into their segments,
    ``dest_offsets[d]:dest_offsets[d + 1]`` being segment ``d``.

    Each segment adds its rows one at a time in ascending order starting
    from zero, which is the order of XLA's sorted ``segment_sum`` on the
    CPU, on every device (CUDA ``index_add_`` adds with atomics, in an order
    that is not fixed)."""
    n_seg = dest_offsets.shape[0] - 1
    acc = torch.zeros((n_seg,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if values.shape[0] == 0:
        return acc
    start = dest_offsets[:-1].long()
    end = dest_offsets[1:].long()
    last = values.shape[0] - 1
    for k in range(max_per_segment):
        idx = start + k
        take = (idx < end).view((n_seg,) + (1,) * (values.dim() - 1))
        acc = acc + torch.where(take, values[torch.clamp(idx, max=last)], 0)
    return acc


def block_rows_sum(xs, weights, dest_offsets, max_blocks_per_dest: int):
    """For each row r of ``xs`` [R, n_blocks, tile] (row r's source-tile
    slice of every block), the sum over each destination tile's blocks of
    ``xs[r, b] @ weights[b]``, or ``@ weights[r, b]`` for weights with a
    leading ``[R]`` axis: all rows in one product, each destination adding
    its blocks in ascending order (``sorted_segment_sum``). Returns
    ``[n_tiles, R, cols]``."""
    spec = "rbi,bij->brj" if weights.dim() == 3 else "rbi,rbij->brj"
    return sorted_segment_sum(torch.einsum(spec, xs, weights), dest_offsets,
                              max_blocks_per_dest)


def delivery_plain(fired_tiles, weights, counts, src_tiles, dest_offsets,
                   max_blocks_per_dest: int):
    """Plain PyTorch version of the delivery kernel.

    ``fired_tiles`` [n_tiles, tile] 0/1 in the program dtype, ``weights``
    [B, tile, tile] in the same dtype, ``counts`` [B, tile, tile] int8,
    ``src_tiles`` [B] int32, ``dest_offsets`` [n_tiles + 1] int32. Returns
    (currents [n_tiles, tile] in the program dtype, arrival counts
    [n_tiles, tile] int32). Every block is multiplied, active or not."""
    xs = fired_tiles[src_tiles.long()]  # [B, tile] gather
    y = torch.einsum("bi,bij->bj", xs, weights)
    # counts of at most 256 rows x 127 are exact in float32
    cnt = torch.einsum("bi,bij->bj", xs.to(torch.float32),
                       counts.to(torch.float32))
    return (
        sorted_segment_sum(y, dest_offsets, max_blocks_per_dest),
        sorted_segment_sum(cnt, dest_offsets, max_blocks_per_dest).to(
            torch.int32),
    )


def pack_arrival_plane(counts: torch.Tensor) -> torch.Tensor:
    """The packed arrival plane of ``counts`` [B, tile, tile] (int8 edge
    counts): int32 [B, tile, ceil(tile / 32)], bit ``j % 32`` of word
    ``j // 32`` of row ``i`` set where ``counts[b, i, j] > 0``. One bit a
    cell instead of one byte; built once per program."""
    n_blocks, tile, _ = counts.shape
    words = -(-tile // 32)
    shifts = torch.arange(32, dtype=torch.int64, device=counts.device)
    packed = torch.empty((n_blocks, tile, words), dtype=torch.int32,
                         device=counts.device)
    step = 512  # blocks at a time: the int64 temporaries are 8x the counts
    for lo in range(0, n_blocks, step):
        part = counts[lo : lo + step]
        bits = torch.zeros((part.shape[0], tile, words * 32),
                           dtype=torch.int64, device=counts.device)
        bits[:, :, :tile] = part > 0
        word = (bits.view(-1, tile, words, 32) << shifts).sum(dim=3)
        # bit 31 set: wrap into int32's sign bit
        packed[lo : lo + step] = torch.where(word >= 2**31, word - 2**32,
                                             word).to(torch.int32)
    return packed


def unpack_arrival_plane(arrivals: torch.Tensor, tile: int) -> torch.Tensor:
    """Inverse of ``pack_arrival_plane``: bool [B, tile, tile]."""
    shifts = torch.arange(32, dtype=torch.int32, device=arrivals.device)
    bits = (arrivals.unsqueeze(3) >> shifts) & 1
    return bits.view(arrivals.shape[0], arrivals.shape[1], -1)[:, :, :tile] > 0


def delivery_packed_plain(fired_tiles, weights, arrivals, src_tiles,
                          dest_offsets, max_blocks_per_dest: int):
    """``delivery_plain`` over the unpacked arrival plane, on
    ``delivery_kernel``'s arguments but the live-row list: every block
    multiplied, the semantics the list is held to. Returns (currents,
    arrived bool [n_tiles, tile])."""
    counts = unpack_arrival_plane(arrivals, fired_tiles.shape[1]).to(
        torch.int8)
    cur, cnt = delivery_plain(fired_tiles, weights, counts, src_tiles,
                              dest_offsets, max_blocks_per_dest)
    return cur, cnt > 0


class LiveRows(NamedTuple):
    """Each block's live rows in ascending order: block ``k``'s are
    ``rows[offsets[k]:offsets[k + 1]]``. ``rows`` is uint8, padded with
    zeros to a multiple of 16 bytes (at least 16); ``offsets`` is int32
    ``[n_blocks + 1]``; ``count`` is ``offsets[-1]``, kept on the host."""

    rows: torch.Tensor
    offsets: torch.Tensor
    count: int


def _live_rows_of(live: torch.Tensor) -> LiveRows:
    """``LiveRows`` of a bool ``[n_blocks, tile]`` live-row mask."""
    n_blocks = live.shape[0]
    offsets = torch.zeros(n_blocks + 1, dtype=torch.int32, device=live.device)
    offsets[1:] = torch.cumsum(live.sum(dim=1), dim=0)
    index = live.nonzero()[:, 1]  # row-major: blocks, then rows, ascending
    count = index.numel()
    rows = torch.zeros(max(16, -(-count // 16) * 16), dtype=torch.uint8,
                       device=live.device)
    rows[:count] = index
    return LiveRows(rows, offsets, count)


def build_live_rows(weights: torch.Tensor,
                    arrivals: torch.Tensor) -> LiveRows:
    """The live rows of the blocks: a row is live where any of its weights
    is not +-0.0 (a NaN or inf weight counts) or any of its arrival bits is
    set. ``weights`` [n_blocks, tile, tile] and ``arrivals`` [n_blocks,
    tile, words] (``pack_arrival_plane``), either with a leading ``[B]``
    axis of per-sample sets: then the union over the samples. Built once,
    on the tensors' device; ``delivery_batch_kernel`` reads only these
    rows."""
    n_blocks, tile = weights.shape[-3], weights.shape[-2]
    live = torch.zeros((n_blocks, tile), dtype=torch.bool,
                       device=weights.device)
    step = 256  # blocks at a time: the bool temporaries are a byte a cell
    for lo in range(0, n_blocks, step):
        hi = min(lo + step, n_blocks)
        part = (weights[..., lo:hi, :, :] != 0).any(dim=-1) | (
            arrivals[..., lo:hi, :, :] != 0).any(dim=-1)
        live[lo:hi] = part.reshape(-1, hi - lo, tile).any(dim=0)
    return _live_rows_of(live)


def every_row_live(n_blocks: int, tile: int, device) -> LiveRows:
    """A ``LiveRows`` listing every row of every block (what dense
    connectivity gives)."""
    return _live_rows_of(torch.ones((n_blocks, tile), dtype=torch.bool,
                                    device=device))


def _list_blocks(live_rows: LiveRows) -> torch.Tensor:
    """The block of each listed row, int64 ``[count]``, in list order."""
    offsets = live_rows.offsets.long()
    n_blocks = offsets.numel() - 1
    count = live_rows.count
    if n_blocks < 0 or int(offsets[-1]) != count:
        raise ValueError(f"delivery_kernel: live_rows lists {count} rows, "
                         f"its offsets end at {offsets[-1:].tolist()}")
    return torch.repeat_interleave(
        torch.arange(n_blocks, device=offsets.device), offsets.diff(),
        output_size=count)


def live_row_ids(live_rows: LiveRows, tile: int) -> torch.Tensor:
    """Each listed row's index ``b * tile + i`` among the dense blocks'
    rows (live row ``i`` of block ``b``), int64 ``[count]``, ascending."""
    return (_list_blocks(live_rows) * tile
            + live_rows.rows[:live_rows.count].long())


def compact_blocks(weights: torch.Tensor, arrivals: torch.Tensor,
                   live_rows: Optional[LiveRows] = None) -> tuple:
    """(live_rows, weights ``[..., count, tile]``, arrivals ``[..., count,
    words]``): the rows of dense blocks ``weights`` [..., n_blocks, tile,
    tile] and ``arrivals`` [..., n_blocks, tile, words] that ``live_rows``
    lists (``build_live_rows`` of them where None), in list order, each
    leading ``[B]`` axis kept: the operands of the kernels, which hold no
    other row."""
    tile, words = weights.shape[-2], arrivals.shape[-1]
    if live_rows is None:
        live_rows = build_live_rows(weights, arrivals)
    ids = live_row_ids(live_rows, tile).to(weights.device)
    w = weights.reshape(tuple(weights.shape[:-3]) + (-1, tile))
    a = arrivals.reshape(tuple(arrivals.shape[:-3]) + (-1, words))
    return (live_rows, w.index_select(w.dim() - 2, ids).contiguous(),
            a.index_select(a.dim() - 2, ids.to(a.device)).contiguous())


def dense_blocks(rows: Optional[torch.Tensor], words: Optional[torch.Tensor],
                 live_rows: LiveRows, n_blocks: int,
                 tile: Optional[int] = None) -> tuple:
    """``compact_blocks``'s inverse: (weights ``[..., n_blocks, tile,
    tile]``, arrivals ``[..., n_blocks, tile, words]``) holding ``rows``
    ``[..., count, tile]`` and ``words`` ``[..., count, words]`` at the
    rows ``live_rows`` lists and zeros elsewhere, each leading ``[B]`` axis
    kept: the operands of the plain versions that multiply every row.
    Either may be None, and is then None in the result; ``tile`` defaults
    to the width of ``rows``."""
    tile = rows.shape[-1] if tile is None else tile
    ids = live_row_ids(live_rows, tile)

    def place(x):
        if x is None:
            return None
        lead = tuple(x.shape[:-2])
        out = torch.zeros(lead + (n_blocks * tile, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
        out.index_copy_(out.dim() - 2, ids.to(x.device), x)
        return out.view(lead + (n_blocks, tile, x.shape[-1]))

    return place(rows), place(words)


def live_entries(live_rows: LiveRows, src_tiles, dest_offsets, tile: int):
    """The list as the kernel walks it, in list order (blocks ascending,
    rows ascending within a block): int32 ``[count, 2]`` pairs (row ``r``
    of the compact weights, which is entry ``r`` itself; source neuron
    ``src_tiles[b] * tile + i``) of live row ``i`` of block ``b``, and each
    destination tile's first entry, int32 ``[n_tiles + 1]`` (the blocks are
    sorted dest-major, so a tile's entries are contiguous). Built once a
    program, on the list's device."""
    block = _list_blocks(live_rows)
    count = live_rows.count
    row = live_rows.rows[:count].long()
    entries = torch.stack(
        [torch.arange(count, device=block.device),
         src_tiles.long()[block] * tile + row], dim=1).to(torch.int32)
    return entries, live_rows.offsets.long()[dest_offsets.long()].to(
        torch.int32)


def _live_sum(fired_tiles, weights, arrivals, entries, tile_entries):
    """``delivery_live_plain`` on the compact rows (``weights`` [count,
    tile], ``arrivals`` [count, words]) and the list's entries
    (``live_entries``)."""
    n_tiles, tile = fired_tiles.shape
    wrow = entries[:, 0].long()
    src = entries[:, 1].long()
    keep = torch.nonzero(fired_tiles.reshape(-1)[src] != 0).flatten()
    kept = wrow[keep]  # ascending: list order
    # the destination tile of each kept entry
    dest = torch.searchsorted(tile_entries[1:].long(), keep, right=True)
    per_tile = torch.bincount(dest, minlength=n_tiles)
    offsets = torch.zeros(n_tiles + 1, dtype=torch.int64,
                          device=fired_tiles.device)
    offsets[1:] = torch.cumsum(per_tile, dim=0)
    cur = sorted_segment_sum(weights.reshape(-1, tile)[kept], offsets,
                             int(per_tile.max()) if kept.numel() else 0)
    words = arrivals.shape[-1]
    shifts = torch.arange(32, dtype=torch.int32, device=arrivals.device)
    bits = ((arrivals.reshape(-1, words)[kept].unsqueeze(2) >> shifts) & 1
            ).reshape(kept.numel(), 32 * words)[:, :tile]
    seen = torch.zeros((n_tiles, tile), dtype=torch.int32,
                       device=fired_tiles.device)
    seen.index_add_(0, dest, bits.to(torch.int32))
    return cur, seen > 0


def delivery_live_plain(fired_tiles, weights, arrivals, src_tiles,
                        dest_offsets, max_blocks_per_dest: int,
                        live_rows: LiveRows):
    """Plain version of ``delivery_kernel``, in its order: for each
    destination tile, one accumulator per column from +0.0, adding the
    listed rows that fired in list order (blocks ascending, rows ascending
    within a block), and the OR of their arrival bits. Arguments and
    results as ``delivery_kernel``'s. A row left out of the list holds only
    +-0.0 weights and no arrival bit and changes no bit of such a sum, so
    this equals adding every fired row in that order, for any weights, and
    equals ``delivery_packed_plain`` wherever the partial sums are exact
    (integer weights). ``weights`` and ``arrivals`` are the dense blocks,
    [B, tile, tile] and [B, tile, words], or the listed rows alone,
    [count, tile] and [count, words], as ``delivery_kernel`` takes them."""
    del max_blocks_per_dest
    rows, words = weights, arrivals
    if weights.dim() == 3:
        _, rows, words = compact_blocks(weights, arrivals, live_rows)
    return _live_sum(fired_tiles, rows, words,
                     *live_entries(live_rows, src_tiles, dest_offsets,
                                   fired_tiles.shape[1]))


@functools.cache
def _library():
    import ctypes

    lib = load(DELIVERY)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sanafe_delivery_launch.restype = i32
    lib.sanafe_delivery_launch.argtypes = [vp] * 7 + [i32] * 4 + [vp]
    lib.sanafe_delivery_smem.restype = ctypes.c_longlong
    lib.sanafe_delivery_smem.argtypes = [i32] * 3
    lib.sanafe_delivery_cells_launch.restype = i32
    lib.sanafe_delivery_cells_launch.argtypes = [vp] * 7 + [i32] * 5 + [vp]
    lib.sanafe_delivery_cells_ctas.restype = i32
    lib.sanafe_delivery_cells_ctas.argtypes = [i32] * 3
    lib.sanafe_delivery_error_string.restype = ctypes.c_char_p
    lib.sanafe_delivery_error_string.argtypes = [i32]
    return lib


class Delivery(NamedTuple):
    """``delivery_kernel``'s operands but the fired plane, checked once
    (``plan_delivery``): a launch (``delivery_launch``) then checks only its
    plane. ``weights`` and ``arrivals`` are the compact rows; ``entries``
    and ``tile_entries`` are the list as the kernel walks it
    (``live_entries``); ``launch`` holds the library's arguments after the
    plane's pointer (None for CPU tensors, which take the plain sum)."""

    weights: torch.Tensor
    arrivals: torch.Tensor
    src_tiles: torch.Tensor
    dest_offsets: torch.Tensor
    max_blocks_per_dest: int
    live_rows: LiveRows
    entries: torch.Tensor
    tile_entries: torch.Tensor
    shape: tuple  # the plane's (n_tiles, tile)
    launch: Optional[tuple]

    @property
    def args(self) -> tuple:
        """``delivery_kernel``'s arguments after the fired plane."""
        return (self.weights, self.arrivals, self.src_tiles,
                self.dest_offsets, self.max_blocks_per_dest, self.live_rows)


def plan_delivery(weights, arrivals, src_tiles, dest_offsets,
                  max_blocks_per_dest: int, live_rows: LiveRows) -> Delivery:
    """Check ``delivery_kernel``'s operands but the fired plane (arguments
    as its own), ask the library whether the shape fits a CTA's shared
    memory, and expand the list into the entries the kernel walks, once: a
    kernel-delivery program builds its plan with the program, so a shape
    the kernel refuses raises there, and a step's launch pays none of it
    and stays capturable."""
    n_tiles = dest_offsets.shape[0] - 1
    n_blocks, tile = src_tiles.shape[0], weights.shape[-1]
    plan = dict(weights=weights, arrivals=arrivals, src_tiles=src_tiles,
                dest_offsets=dest_offsets,
                max_blocks_per_dest=int(max_blocks_per_dest),
                live_rows=live_rows, shape=(n_tiles, tile), launch=None)
    dev = weights.device
    if dev.type == "cpu":  # the plain version's operands, unchecked
        entries, tile_entries = live_entries(live_rows, src_tiles,
                                             dest_offsets, tile)
        return Delivery(**plan, entries=entries, tile_entries=tile_entries)
    if dev.type != "cuda":
        raise ValueError(f"delivery_kernel: unsupported device {dev}")
    dtype = weights.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"delivery_kernel: unsupported dtype {dtype}")
    if not 0 < tile <= MAX_TILE or tile % 4:
        raise ValueError(f"delivery_kernel: tile {tile} is not a multiple "
                         f"of 4 up to {MAX_TILE}")
    if not isinstance(live_rows, LiveRows):
        raise ValueError("delivery_kernel: live_rows must be a LiveRows "
                         "(build_live_rows)")
    count = live_rows.count
    if count >= 2**31:
        raise ValueError("delivery_kernel: the kernel indexes weight rows "
                         "with int32; 2**31 or more rows")
    n_live = live_rows.rows.numel()
    if n_live % 16 or not 0 <= count <= min(n_live, n_blocks * tile):
        raise ValueError(
            f"delivery_kernel: live_rows lists {count} rows in "
            f"{n_live} bytes for {n_blocks} blocks of {tile} rows")
    expect = (
        ("weights", weights, (count, tile), dtype),
        ("arrivals", arrivals, (count, -(-tile // 32)), torch.int32),
        ("src_tiles", src_tiles, (n_blocks,), torch.int32),
        ("dest_offsets", dest_offsets, (n_tiles + 1,), torch.int32),
        ("live_rows.rows", live_rows.rows, (n_live,), torch.uint8),
        ("live_rows.offsets", live_rows.offsets, (n_blocks + 1,),
         torch.int32),
    )
    for name, x, want, dt in expect:
        if (x.device != dev or x.shape != want or x.dtype != dt
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(
                f"delivery_kernel: {name} must be a contiguous, 16-byte "
                f"aligned {dt} tensor of shape {want} on {dev}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    is_double = int(dtype == torch.float64)
    if _library().sanafe_delivery_smem(n_tiles, tile, is_double) < 0:
        raise ValueError(
            f"delivery_kernel: {n_tiles} tiles of {tile} {dtype} need more "
            "than a CTA's 227 KB of shared memory")
    # fresh allocations, so 16-byte aligned; an empty list is not read
    entries, tile_entries = live_entries(live_rows, src_tiles, dest_offsets,
                                         tile)
    plan.update(entries=entries, tile_entries=tile_entries,
                launch=(weights.data_ptr(), arrivals.data_ptr(),
                        entries.data_ptr(), tile_entries.data_ptr(), n_tiles,
                        tile, is_double, dev.index or 0))
    return Delivery(**plan)


class DeliveryCells(NamedTuple):
    """The blocks' edge cells destination-major: destination neuron ``d``'s
    cells (a (source, destination) pair that holds an edge; its weight the
    edges' sum cast once to the program dtype) in ascending order of their
    source neuron, which is the live rows' order of adds for column
    ``d % tile`` (blocks ascending, rows ascending within a block). Sliced
    by ``CELL_SLICE`` destinations, each slice padded to its longest list
    rounded up to ``CELL_GROUP``: a destination's cells lie in groups of
    ``CELL_GROUP``, and group ``g`` of the slice's destinations lie side by
    side (``cell_slot``), so a warp's lanes, a destination each, read their
    ``g``-th groups together, 16 bytes of sources a lane. ``src`` int32
    and ``weights`` (the program dtype) ``[slots]``, zeros in the padding;
    ``lengths`` int32 ``[n]``, each destination's cells; ``starts`` int64
    ``[n_slices + 1]``, each slice's first slot; kept on the host, ``count``
    the cells, ``longest`` the longest destination's and ``rows`` the live
    rows the same cells fill (what the rows' path would hold)."""

    src: torch.Tensor
    weights: torch.Tensor
    lengths: torch.Tensor
    starts: torch.Tensor
    count: int
    longest: int
    rows: int


def cell_slot(starts, dest, k):
    """The slot of cell ``k`` of destination ``dest`` (numpy or torch
    integers) in cells whose slices start at ``starts``."""
    return (starts[dest // CELL_SLICE]
            + k // CELL_GROUP * (CELL_SLICE * CELL_GROUP)
            + dest % CELL_SLICE * CELL_GROUP + k % CELL_GROUP)


def listed_cells(cells: DeliveryCells) -> tuple:
    """(destination, slot) of every cell ``cells`` holds, int64 tensors,
    destination by destination, each's in source order."""
    lengths = cells.lengths.long()
    dest = torch.repeat_interleave(
        torch.arange(lengths.numel(), device=lengths.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    k = torch.arange(len(dest), device=lengths.device) - first[dest]
    return dest, cell_slot(cells.starts, dest, k)


def delivery_us(n_cells: int, longest: int, n_rows: int, n_tiles: int,
                tile: int, dtype, fired: float = 1.0) -> tuple:
    """The kernel's modelled time a step in microseconds, (over the live
    rows, over the cells), for ``n_rows`` live rows of ``tile`` columns (a
    weight a column and the arrival words) into ``n_tiles`` destination
    tiles, a share ``fired`` of them fired, and ``n_cells`` cells (a source
    index and a weight), the longest destination's ``longest``."""
    size = torch.empty((), dtype=dtype).element_size()
    row_bytes = tile * size + 4 * -(-tile // 32)
    rows = (ROWS_US + ROW_ENTRY_NS * 1e-3 * n_rows / n_tiles
            + fired * n_rows * row_bytes
            / (ROWS_GB_S * 1e3 * min(1.0, n_tiles / ROWS_TILES)))
    cells = CELLS_US + max(n_cells * (4 + size) / (CELLS_GB_S * 1e3),
                           longest * CELL_CHAIN_NS * 1e-3)
    return rows, cells


def cells_faster(n_cells: int, longest: int, n_rows: int, n_tiles: int,
                 tile: int, dtype, fired: float = 1.0) -> bool:
    """Whether a kernel program holds the cells instead of the live rows:
    where the kernel's modelled time over them (``delivery_us``) is below
    its time over the rows, a share ``fired`` of them fired."""
    rows, cells = delivery_us(n_cells, longest, n_rows, n_tiles, tile,
                              dtype, fired)
    return cells < rows


def build_delivery_cells(dest: np.ndarray, src: np.ndarray,
                         weights: torch.Tensor, n: int,
                         rows: int) -> DeliveryCells:
    """``DeliveryCells`` of the cells ``dest`` and ``src`` (int64,
    destination and source neuron, sorted by destination then source, each
    pair once) with ``weights`` (the program dtype, on the device the cells
    are built on) into ``n`` destination neurons, which fill ``rows`` live
    rows."""
    device = weights.device
    count = len(dest)
    lengths = np.bincount(dest, minlength=n)
    n_slices = -(-n // CELL_SLICE)
    padded = np.zeros(n_slices * CELL_SLICE, dtype=np.int64)
    padded[:n] = lengths
    groups = -(-padded.reshape(n_slices, CELL_SLICE).max(axis=1)
               // CELL_GROUP)
    starts = np.zeros(n_slices + 1, dtype=np.int64)
    starts[1:] = np.cumsum(groups * (CELL_SLICE * CELL_GROUP))
    first = np.zeros(n + 1, dtype=np.int64)
    first[1:] = np.cumsum(lengths)
    slot = cell_slot(starts, dest, np.arange(count) - first[dest])
    src_slots = np.zeros(int(starts[-1]), dtype=np.int32)
    src_slots[slot] = src
    w_slots = torch.zeros(int(starts[-1]), dtype=weights.dtype,
                          device=device)
    w_slots[torch.from_numpy(slot).to(device)] = weights
    return DeliveryCells(
        src=torch.from_numpy(src_slots).to(device), weights=w_slots,
        lengths=torch.from_numpy(lengths.astype(np.int32)).to(device),
        starts=torch.from_numpy(starts).to(device), count=count,
        longest=int(lengths.max(initial=0)), rows=rows)


def delivery_cells_plain(fired_tiles, cells: DeliveryCells):
    """Plain version of ``delivery_kernel`` over the cells, in its order:
    for each destination neuron, one accumulator from +0.0 adding its cells
    whose source fired, in source order, and whether any did.
    ``fired_tiles`` [n_tiles, tile] 0/1 in the program dtype; returns
    (currents, arrived) as ``delivery_kernel``. It adds what
    ``delivery_live_plain`` adds over the rows that hold the same cells, in
    the same order, less the +0.0 of the columns without an edge, which
    changes no bit of a sum from +0.0: the same bits for any weights."""
    shape = fired_tiles.shape
    fired = fired_tiles.reshape(-1) != 0
    dest = torch.arange(fired.numel(), device=fired.device)
    lengths = cells.lengths.long()
    acc = torch.zeros(fired.numel(), dtype=fired_tiles.dtype,
                      device=fired.device)
    seen = torch.zeros(fired.numel(), dtype=torch.bool, device=fired.device)
    for k in range(int(lengths.max())):
        has = k < lengths
        slot = torch.where(has, cell_slot(cells.starts, dest, k), 0)
        take = has & fired[cells.src[slot].long()]
        acc = torch.where(take, acc + cells.weights[slot], acc)
        seen |= take
    return acc.view(shape), seen.view(shape)


class CellDelivery(NamedTuple):
    """``delivery_kernel``'s operands on the cells, checked once
    (``plan_delivery_cells``): the cells, the plane's ``shape`` and the
    library's arguments after the plane's pointer (``launch``; None for
    CPU tensors, which take the plain sum)."""

    cells: DeliveryCells
    shape: tuple  # the plane's (n_tiles, tile)
    launch: Optional[tuple]


def plan_delivery_cells(cells: DeliveryCells, shape: tuple) -> CellDelivery:
    """Check the cells for planes of ``shape`` (n_tiles, tile) and ask the
    library how many CTAs of the cell kernel the card holds at once, once:
    a kernel program plans its cells with the program, as
    ``plan_delivery`` its rows."""
    n_tiles, tile = shape
    n = n_tiles * tile
    dev = cells.weights.device
    if dev.type == "cpu":
        return CellDelivery(cells, tuple(shape), None)
    if dev.type != "cuda":
        raise ValueError(f"delivery_kernel: unsupported device {dev}")
    dtype = cells.weights.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"delivery_kernel: unsupported dtype {dtype}")
    slots = cells.src.numel()
    n_slices = -(-n // CELL_SLICE)
    expect = (
        ("cells.src", cells.src, (slots,), torch.int32),
        ("cells.weights", cells.weights, (slots,), dtype),
        ("cells.lengths", cells.lengths, (n,), torch.int32),
        ("cells.starts", cells.starts, (n_slices + 1,), torch.int64),
    )
    for name, x, want, dt in expect:
        if (x.device != dev or x.shape != want or x.dtype != dt
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(
                f"delivery_kernel: {name} must be a contiguous, 16-byte "
                f"aligned {dt} tensor of shape {want} on {dev}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if int(cells.starts[-1]) != slots:
        raise ValueError(f"delivery_kernel: the cells' slices end at "
                         f"{int(cells.starts[-1])}, not at {slots} slots")
    is_double = int(dtype == torch.float64)
    index = dev.index or 0
    ctas = _library().sanafe_delivery_cells_ctas(n, is_double, index)
    if ctas <= 0:
        raise ValueError(f"delivery_kernel: the cell kernel for {n} neurons "
                         f"cannot be placed on {dev} (CUDA error {-ctas})")
    return CellDelivery(cells, tuple(shape), (
        cells.src.data_ptr(), cells.weights.data_ptr(),
        cells.lengths.data_ptr(), cells.starts.data_ptr(), n, n_slices, ctas,
        is_double, index))


def delivery_launch(fired_tiles, plan: Union[Delivery, CellDelivery]):
    """``delivery_kernel`` on ``plan``'s operands, the live rows
    (``plan_delivery``) or the cells (``plan_delivery_cells``): the CUDA
    kernel for a CUDA plane, ``delivery_live_plain`` or
    ``delivery_cells_plain`` for a CPU one. Checks only the plane
    ``fired_tiles`` ([n_tiles, tile], the plan's shape, in the weights'
    dtype), allocates the outputs and launches on the current stream;
    counts on ``delivery_kernel.launches``."""
    dev = fired_tiles.device
    on_cells = isinstance(plan, CellDelivery)
    if dev.type == "cpu":
        if on_cells:
            return delivery_cells_plain(fired_tiles, plan.cells)
        return _live_sum(fired_tiles, plan.weights, plan.arrivals,
                         plan.entries, plan.tile_entries)
    weights = plan.cells.weights if on_cells else plan.weights
    dtype = weights.dtype
    if (plan.launch is None or dev != weights.device
            or fired_tiles.dtype != dtype
            or tuple(fired_tiles.shape) != plan.shape
            or not fired_tiles.is_contiguous()
            or fired_tiles.data_ptr() % 16):
        raise ValueError(
            f"delivery_kernel: fired_tiles must be a contiguous, 16-byte "
            f"aligned {dtype} tensor of shape {plan.shape} on "
            f"{weights.device}; got {fired_tiles.dtype} "
            f"{tuple(fired_tiles.shape)} on {dev}")
    out_cur = torch.empty(plan.shape, dtype=dtype, device=dev)
    arrived = torch.empty(plan.shape, dtype=torch.bool, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if on_cells:
        src, w, lengths, starts, n, n_slices, ctas, is_double, index = \
            plan.launch
        err = lib.sanafe_delivery_cells_launch(
            fired_tiles.data_ptr(), src, w, lengths, starts,
            out_cur.data_ptr(), arrived.data_ptr(), n, n_slices, ctas,
            is_double, index, stream)
    else:
        w, a, entries, tile_entries, n_tiles, tile, is_double, index = \
            plan.launch
        err = lib.sanafe_delivery_launch(
            fired_tiles.data_ptr(), w, a, entries, tile_entries,
            out_cur.data_ptr(), arrived.data_ptr(), n_tiles, tile,
            is_double, index, stream)
    if err:
        raise RuntimeError("delivery kernel launch failed: "
                           + lib.sanafe_delivery_error_string(err).decode())
    delivery_kernel.launches += 1
    return out_cur, arrived


def delivery_kernel(fired_tiles, weights, arrivals, src_tiles, dest_offsets,
                    max_blocks_per_dest: int, live_rows: LiveRows):
    """One delivery: the CUDA kernel for CUDA tensors, the same sum in
    PyTorch for CPU tensors.

    ``fired_tiles`` [n_tiles, tile] 0/1 in the program dtype; ``live_rows``
    the blocks' live rows (``build_live_rows``, or a list with more rows,
    such as ``every_row_live``); ``weights`` [count, tile] in the program
    dtype and ``arrivals`` [count, ceil(tile/32)] int32 the listed rows of
    the weight blocks and of their packed arrival plane
    (``pack_arrival_plane``), row ``r`` the list's ``r``-th
    (``compact_blocks``); ``src_tiles`` [B] int32 and ``dest_offsets``
    [n_tiles + 1] int32 of the B blocks. Returns (currents [n_tiles, tile]
    in the program dtype, arrived [n_tiles, tile] bool), equal bit for bit
    to ``delivery_live_plain``'s over the dense blocks, and to
    ``delivery_plain``'s currents and ``cnt > 0`` wherever the partial sums
    are exact (integer weights).

    The kernel reads only the listed rows that fired, in one launch; it runs
    float32 and float64, launches on the current stream and does not
    synchronise. It checks every operand on each call; a caller that
    launches on the same operands step after step builds ``plan_delivery``
    once and calls ``delivery_launch``. ``delivery_kernel.launches`` counts
    its launches."""
    dev = fired_tiles.device
    if dev.type == "cpu":
        return delivery_launch(fired_tiles, plan_delivery(
            weights, arrivals, src_tiles, dest_offsets, max_blocks_per_dest,
            live_rows))
    if dev.type != "cuda":
        raise ValueError(f"delivery_kernel: unsupported device {dev}")
    if fired_tiles.dim() != 2:
        raise ValueError(
            "delivery_kernel: fired_tiles must be [n_tiles, tile]")
    tile = fired_tiles.shape[1]
    if not 0 < tile <= MAX_TILE or tile % 4:
        raise ValueError(f"delivery_kernel: tile {tile} is not a multiple "
                         f"of 4 up to {MAX_TILE}")
    return delivery_launch(fired_tiles, plan_delivery(
        weights, arrivals, src_tiles, dest_offsets, max_blocks_per_dest,
        live_rows))


delivery_kernel.launches = 0


def delivery_batch_plain(fired_tiles, weights, arrivals, src_tiles,
                         dest_offsets, max_blocks_per_dest: int,
                         live_rows: LiveRows = None):
    """Plain version of ``delivery_batch_kernel``: the einsum and sorted
    segment sum of ``ops/step.py:_block_deliver_rows`` over the samples,
    and the arrival plane ORed over each sample's fired rows (an einsum of
    the unpacked plane, ``> 0``). It multiplies every row: ``live_rows``
    is taken for the kernel's signature and not read.

    ``fired_tiles`` [B, n_tiles, tile] 0/1 in the program dtype;
    ``weights`` [n_blocks, tile, tile] or, one set a sample,
    [B, n_blocks, tile, tile]; ``arrivals`` [n_blocks, tile, words] int32 or
    [B, n_blocks, tile, words]; ``src_tiles`` and ``dest_offsets`` as for
    ``delivery_kernel``. Returns (currents [B, n_tiles, tile], arrived
    [B, n_tiles, tile] bool)."""
    del live_rows
    tile = fired_tiles.shape[2]
    xs = fired_tiles[:, src_tiles.long()]  # [B, n_blocks, tile]
    counts = unpack_arrival_plane(
        arrivals.reshape((-1,) + tuple(arrivals.shape[-2:])), tile).view(
        tuple(arrivals.shape[:-1]) + (tile,)).to(torch.float32)
    cur = block_rows_sum(xs, weights, dest_offsets, max_blocks_per_dest)
    cnt = block_rows_sum(xs.to(torch.float32), counts, dest_offsets,
                         max_blocks_per_dest)
    return cur.transpose(0, 1).contiguous(), cnt.transpose(0, 1) > 0


@functools.cache
def _batch_library():
    import ctypes

    lib = load(DELIVERY_BATCH)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sanafe_delivery_batch_launch.restype = i32
    lib.sanafe_delivery_batch_launch.argtypes = (
        [vp] * 10 + [i64] * 2 + [i32] * 6 + [vp])
    lib.sanafe_delivery_batch_smem.restype = ctypes.c_longlong
    lib.sanafe_delivery_batch_smem.argtypes = [i32] * 6
    lib.sanafe_delivery_batch_error_string.restype = ctypes.c_char_p
    lib.sanafe_delivery_batch_error_string.argtypes = [i32]
    return lib


class BatchDelivery(NamedTuple):
    """``delivery_batch_kernel``'s operands but the fired planes, checked
    once for ``batch`` samples (``plan_delivery_batch``): a launch
    (``delivery_batch_launch``) then checks only its planes. ``weights``
    and ``arrivals`` are the compact rows, shared or one set a sample;
    ``launch`` holds the library's arguments after the planes' pointer
    (None for CPU tensors, which take the plain sum over ``entries`` and
    ``tile_entries``, the list as ``live_entries`` gives it)."""

    weights: torch.Tensor
    arrivals: torch.Tensor
    src_tiles: torch.Tensor
    dest_offsets: torch.Tensor
    max_blocks_per_dest: int
    live_rows: LiveRows
    shape: tuple  # the planes' (batch, n_tiles, tile)
    launch: Optional[tuple]
    arrived_bytes: int  # the arrived planes' bytes, rounded up to 16
    scratch_bytes: int  # the arrived planes and the sample masks
    entries: Optional[torch.Tensor] = None
    tile_entries: Optional[torch.Tensor] = None


def plan_delivery_batch(batch: int, weights, arrivals, src_tiles,
                        dest_offsets, max_blocks_per_dest: int,
                        live_rows: LiveRows) -> BatchDelivery:
    """Check ``delivery_batch_kernel``'s shared operands for ``batch``
    samples (arguments as its own) and ask the library for the launch's
    shared memory, once: ``ParameterSweep`` builds its plan with the
    program, so a step's launch pays neither."""
    n_tiles = dest_offsets.shape[0] - 1
    n_blocks, tile = src_tiles.shape[0], weights.shape[-1]
    shape = (batch, n_tiles, tile)
    plan = dict(weights=weights, arrivals=arrivals, src_tiles=src_tiles,
                dest_offsets=dest_offsets,
                max_blocks_per_dest=int(max_blocks_per_dest),
                live_rows=live_rows, shape=shape, launch=None,
                arrived_bytes=0, scratch_bytes=0)
    dev = weights.device
    if dev.type == "cpu":
        entries, tile_entries = live_entries(live_rows, src_tiles,
                                             dest_offsets, tile)
        return BatchDelivery(**plan, entries=entries,
                             tile_entries=tile_entries)
    if dev.type != "cuda":
        raise ValueError(f"delivery_batch_kernel: unsupported device {dev}")
    dtype = weights.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"delivery_batch_kernel: unsupported dtype {dtype}")
    if batch <= 0:
        raise ValueError("delivery_batch_kernel: fired_tiles must be "
                         "[B, n_tiles, tile] with B > 0")
    if not 8 <= tile <= MAX_TILE or tile & (tile - 1):
        raise ValueError(f"delivery_batch_kernel: tile {tile} is not a "
                         f"power of two in [8, {MAX_TILE}]")
    if not isinstance(live_rows, LiveRows):
        raise ValueError("delivery_batch_kernel: live_rows must be a "
                         "LiveRows (build_live_rows)")
    count = live_rows.count
    if count >= 2**31:
        raise ValueError("delivery_batch_kernel: the kernel indexes weight "
                         "rows with int32; 2**31 or more rows")
    n_live = live_rows.rows.numel()
    if n_live % 16 or not 0 <= count <= min(n_live, n_blocks * tile):
        raise ValueError(
            f"delivery_batch_kernel: live_rows lists {count} rows "
            f"in {n_live} bytes for {n_blocks} blocks of {tile} rows")
    words = -(-tile // 32)
    w_shape = (count, tile)
    a_shape = (count, words)
    if weights.dim() == 3:
        w_shape = (batch,) + w_shape
    if arrivals.dim() == 3:
        a_shape = (batch,) + a_shape
    expect = (
        ("weights", weights, w_shape, dtype),
        ("arrivals", arrivals, a_shape, torch.int32),
        ("src_tiles", src_tiles, (n_blocks,), torch.int32),
        ("dest_offsets", dest_offsets, (n_tiles + 1,), torch.int32),
        ("live_rows.rows", live_rows.rows, (n_live,), torch.uint8),
        ("live_rows.offsets", live_rows.offsets, (n_blocks + 1,),
         torch.int32),
    )
    pointers = []
    for name, x, want, dt in expect:
        ptr = x.data_ptr()
        if (x.device != dev or x.shape != want or x.dtype != dt
                or not x.is_contiguous() or ptr % 16):
            raise ValueError(
                f"delivery_batch_kernel: {name} must be a contiguous, "
                f"16-byte aligned {dt} tensor of shape {want} on {dev}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
        pointers.append(ptr)
    # 64-bit element offsets: a sample's rows may pass 2**31 elements
    w_stride = count * tile if weights.dim() == 3 else 0
    a_stride = count * words if arrivals.dim() == 3 else 0
    is_double = int(dtype == torch.float64)
    blk_cap = plan["max_blocks_per_dest"]
    per_sample = int(bool(w_stride or a_stride))
    if _batch_library().sanafe_delivery_batch_smem(
            batch, n_tiles, tile, blk_cap, is_double, per_sample) < 0:
        raise ValueError(
            f"delivery_batch_kernel: {n_tiles} tiles of {tile} with up to "
            f"{blk_cap} blocks a tile need more than a CTA's 227 KB of "
            "shared memory")
    # one scratch allocation a launch, 16-byte aligned parts: the arrived
    # planes, then the kernel's scratch, each neuron's sample mask
    # (ceil(B/32) int32 words a neuron, word-major)
    n = n_tiles * tile
    arrived_bytes = -(-batch * n // 16) * 16
    plan.update(
        launch=(*pointers, w_stride, a_stride, batch, n_tiles, tile, blk_cap,
                is_double, dev.index or 0),
        arrived_bytes=arrived_bytes,
        scratch_bytes=arrived_bytes + 4 * n * -(-batch // 32))
    return BatchDelivery(**plan)


def _live_batch_sum(fired_tiles, plan: BatchDelivery):
    """``delivery_batch_kernel``'s sums in PyTorch: each sample's
    ``_live_sum`` over its rows (the shared ones, or its own)."""
    cur, arrived = [], []
    for b in range(fired_tiles.shape[0]):
        w = plan.weights[b] if plan.weights.dim() == 3 else plan.weights
        a = plan.arrivals[b] if plan.arrivals.dim() == 3 else plan.arrivals
        c, v = _live_sum(fired_tiles[b], w, a, plan.entries,
                         plan.tile_entries)
        cur.append(c)
        arrived.append(v)
    return torch.stack(cur), torch.stack(arrived)


def delivery_batch_launch(fired_tiles, plan: BatchDelivery):
    """``delivery_batch_kernel`` on ``plan``'s operands: the CUDA kernels
    for CUDA planes, the same sums in PyTorch for CPU ones. Checks only the
    planes ``fired_tiles`` ([B, n_tiles, tile], the plan's shape, in the
    weights' dtype), allocates the outputs and launches on the current
    stream; counts on ``delivery_batch_kernel.launches``."""
    dev = fired_tiles.device
    if dev.type == "cpu":
        return _live_batch_sum(fired_tiles, plan)
    dtype = plan.weights.dtype
    if (plan.launch is None or dev != plan.weights.device
            or fired_tiles.dtype != dtype
            or tuple(fired_tiles.shape) != plan.shape
            or not fired_tiles.is_contiguous()
            or fired_tiles.data_ptr() % 16):
        raise ValueError(
            f"delivery_batch_kernel: fired_tiles must be a contiguous, "
            f"16-byte aligned {dtype} tensor of shape {plan.shape} on "
            f"{plan.weights.device}; got {fired_tiles.dtype} "
            f"{tuple(fired_tiles.shape)} on {dev}")
    out_cur = torch.empty(plan.shape, dtype=dtype, device=dev)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    lib = _batch_library()
    *pointers, w_stride, a_stride, batch, n_tiles, tile, blk_cap, \
        is_double, index = plan.launch
    err = lib.sanafe_delivery_batch_launch(
        fired_tiles.data_ptr(), *pointers, base + plan.arrived_bytes,
        out_cur.data_ptr(), base, w_stride, a_stride, batch, n_tiles, tile,
        blk_cap, is_double, index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            "delivery batch kernel launch failed: "
            + lib.sanafe_delivery_batch_error_string(err).decode())
    delivery_batch_kernel.launches += 1
    n = n_tiles * tile
    arrived = scratch[: batch * n].view(torch.bool).view(plan.shape)
    return out_cur, arrived


def delivery_batch_kernel(fired_tiles, weights, arrivals, src_tiles,
                          dest_offsets, max_blocks_per_dest: int,
                          live_rows: LiveRows):
    """B deliveries at once: the CUDA kernels (the sample masks, then the
    sums) for CUDA tensors, the same sums in PyTorch for CPU tensors.
    Arguments and results as ``delivery_batch_plain``'s but the blocks:
    ``weights`` [count, tile] or, one set a sample, [B, count, tile], and
    ``arrivals`` [count, words] or [B, count, words], the rows
    ``live_rows`` lists (``compact_blocks``; with per-sample sets, the
    union of their live rows). It checks every operand on each call; a
    caller that launches on the same operands step after step builds
    ``plan_delivery_batch`` once and calls ``delivery_batch_launch``.

    The kernel reads only the listed rows that some sample fired, each once
    a step for all samples sharing ``weights`` and ``arrivals``, and adds it
    into every sample that fired it. A leading ``[B]`` axis on either (a
    sweep that overrides ``block_weights`` or ``block_counts``) makes it
    read each sample's own, that sample's fired rows only; the list is then
    the union over the samples. Each sample adds its fired rows in
    ascending order within a block and its blocks in ascending order, from
    +0.0; an unlisted row holds only +-0.0 and changes no bit of a sum. So
    two launches on the same inputs give the same bits, each sample equals
    ``delivery_kernel``'s delivery of its plane bit for bit (the same
    order), and the result equals ``delivery_batch_plain`` bit for bit
    wherever the partial sums are exact (integer weights), and to rounding
    otherwise. Float32 and float64; launches on the current stream and does
    not synchronise.
    ``delivery_batch_kernel.launches`` counts its launches."""
    dev = fired_tiles.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"delivery_batch_kernel: unsupported device {dev}")
    if fired_tiles.dim() != 3 or fired_tiles.shape[0] == 0:
        raise ValueError("delivery_batch_kernel: fired_tiles must be "
                         "[B, n_tiles, tile] with B > 0")
    plan = plan_delivery_batch(fired_tiles.shape[0], weights, arrivals,
                               src_tiles, dest_offsets, max_blocks_per_dest,
                               live_rows)
    return delivery_batch_launch(fired_tiles, plan)


delivery_batch_kernel.launches = 0
