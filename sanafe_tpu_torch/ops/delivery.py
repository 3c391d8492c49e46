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
(blocks ascending, rows ascending within a block) from +0.0;
``delivery_live_plain`` is that sum in PyTorch, the wrapper's path for CPU
tensors. A program checks the operands once (``plan_delivery``) and each
step launches (``delivery_launch``).

``delivery_batch_kernel`` (``csrc/delivery_batch_kernel.cu``) is the same
delivery for B fired vectors at once, the sample axis of ``ParameterSweep``
(sanafe_tpu's ``jax.vmap`` of the Pallas kernel): each live weight row
fired in any sample is read once and added into every sample that fired
it, in the same order. Its plain version is ``delivery_batch_plain``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .cuda_build import DELIVERY, DELIVERY_BATCH, load

# a tile is at most this many neurons (the live-row lists hold row indices
# as bytes), and a multiple of 4 (rows are read 16 bytes at a time)
MAX_TILE = 256


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


def live_entries(live_rows: LiveRows, src_tiles, dest_offsets, tile: int):
    """The list as the kernel walks it, in list order (blocks ascending,
    rows ascending within a block): int32 ``[count, 2]`` pairs (weight row
    ``b * tile + i``, source neuron ``src_tiles[b] * tile + i``) of live
    row ``i`` of block ``b``, and each destination tile's first entry,
    int32 ``[n_tiles + 1]`` (the blocks are sorted dest-major, so a tile's
    entries are contiguous). Built once a program, on the list's device."""
    offsets = live_rows.offsets.long()
    n_blocks = offsets.numel() - 1
    count = live_rows.count
    if n_blocks < 0 or int(offsets[-1]) != count:
        raise ValueError(f"delivery_kernel: live_rows lists {count} rows, "
                         f"its offsets end at {offsets[-1:].tolist()}")
    block = torch.repeat_interleave(
        torch.arange(n_blocks, device=offsets.device), offsets.diff(),
        output_size=count)
    row = live_rows.rows[:count].long()
    entries = torch.stack(
        [block * tile + row, src_tiles.long()[block] * tile + row],
        dim=1).to(torch.int32)
    return entries, offsets[dest_offsets.long()].to(torch.int32)


def _live_sum(fired_tiles, weights, arrivals, entries, tile_entries):
    """``delivery_live_plain`` on the list's entries (``live_entries``)."""
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
    (integer weights)."""
    del max_blocks_per_dest
    return _live_sum(fired_tiles, weights, arrivals,
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
    lib.sanafe_delivery_error_string.restype = ctypes.c_char_p
    lib.sanafe_delivery_error_string.argtypes = [i32]
    return lib


class Delivery(NamedTuple):
    """``delivery_kernel``'s operands but the fired plane, checked once
    (``plan_delivery``): a launch (``delivery_launch``) then checks only its
    plane. ``entries`` and ``tile_entries`` are the list as the kernel
    walks it (``live_entries``); ``launch`` holds the library's arguments
    after the plane's pointer (None for CPU tensors, which take the plain
    version)."""

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
    n_blocks, tile = weights.shape[0], weights.shape[1]
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
    if n_blocks * tile >= 2**31:
        raise ValueError("delivery_kernel: the kernel indexes weight rows "
                         "with int32; 2**31 or more rows")
    if not isinstance(live_rows, LiveRows):
        raise ValueError("delivery_kernel: live_rows must be a LiveRows "
                         "(build_live_rows)")
    n_live = live_rows.rows.numel()
    if n_live % 16 or not 0 <= live_rows.count <= min(n_live,
                                                      n_blocks * tile):
        raise ValueError(
            f"delivery_kernel: live_rows lists {live_rows.count} rows in "
            f"{n_live} bytes for {n_blocks} blocks of {tile} rows")
    expect = (
        ("weights", weights, (n_blocks, tile, tile), dtype),
        ("arrivals", arrivals, (n_blocks, tile, -(-tile // 32)),
         torch.int32),
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


def delivery_launch(fired_tiles, plan: Delivery):
    """``delivery_kernel`` on ``plan``'s operands: the CUDA kernel for a
    CUDA plane, ``delivery_live_plain`` for a CPU one. Checks only the
    plane ``fired_tiles`` ([n_tiles, tile], the plan's shape, in the
    weights' dtype), allocates the outputs and launches on the current
    stream; counts on ``delivery_kernel.launches``."""
    dev = fired_tiles.device
    if dev.type == "cpu":
        return _live_sum(fired_tiles, plan.weights, plan.arrivals,
                         plan.entries, plan.tile_entries)
    dtype = plan.weights.dtype
    if (plan.launch is None or dev != plan.weights.device
            or fired_tiles.dtype != dtype
            or tuple(fired_tiles.shape) != plan.shape
            or not fired_tiles.is_contiguous()
            or fired_tiles.data_ptr() % 16):
        raise ValueError(
            f"delivery_kernel: fired_tiles must be a contiguous, 16-byte "
            f"aligned {dtype} tensor of shape {plan.shape} on "
            f"{plan.weights.device}; got {fired_tiles.dtype} "
            f"{tuple(fired_tiles.shape)} on {dev}")
    out_cur = torch.empty(plan.shape, dtype=dtype, device=dev)
    arrived = torch.empty(plan.shape, dtype=torch.bool, device=dev)
    lib = _library()
    w, a, entries, tile_entries, n_tiles, tile, is_double, index = \
        plan.launch
    err = lib.sanafe_delivery_launch(
        fired_tiles.data_ptr(), w, a, entries, tile_entries,
        out_cur.data_ptr(), arrived.data_ptr(), n_tiles, tile, is_double,
        index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("delivery kernel launch failed: "
                           + lib.sanafe_delivery_error_string(err).decode())
    delivery_kernel.launches += 1
    return out_cur, arrived


def delivery_kernel(fired_tiles, weights, arrivals, src_tiles, dest_offsets,
                    max_blocks_per_dest: int, live_rows: LiveRows):
    """One delivery: the CUDA kernel for CUDA tensors,
    ``delivery_live_plain`` for CPU tensors.

    ``fired_tiles`` [n_tiles, tile] 0/1 in the program dtype, ``weights``
    [B, tile, tile] in the same dtype, ``arrivals`` [B, tile,
    ceil(tile/32)] int32 (``pack_arrival_plane``), ``src_tiles`` [B] int32,
    ``dest_offsets`` [n_tiles + 1] int32, ``live_rows`` the blocks' live
    rows (``build_live_rows`` of these weights and arrivals, or a list with
    more rows, such as ``every_row_live``). Returns (currents [n_tiles,
    tile] in the program dtype, arrived [n_tiles, tile] bool), equal to
    ``delivery_live_plain``'s bit for bit, and to ``delivery_plain``'s
    currents and ``cnt > 0`` wherever the partial sums are exact (integer
    weights).

    The kernel reads only the listed rows that fired, in one launch; it runs
    float32 and float64, launches on the current stream and does not
    synchronise. It checks every operand on each call; a caller that
    launches on the same operands step after step builds ``plan_delivery``
    once and calls ``delivery_launch``. ``delivery_kernel.launches`` counts
    its launches."""
    dev = fired_tiles.device
    if dev.type == "cpu":
        return delivery_live_plain(fired_tiles, weights, arrivals,
                                   src_tiles, dest_offsets,
                                   max_blocks_per_dest, live_rows)
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
    (``delivery_batch_launch``) then checks only its planes. ``launch``
    holds the library's arguments after the planes' pointer (None for CPU
    tensors, which take the plain version)."""

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


def plan_delivery_batch(batch: int, weights, arrivals, src_tiles,
                        dest_offsets, max_blocks_per_dest: int,
                        live_rows: LiveRows) -> BatchDelivery:
    """Check ``delivery_batch_kernel``'s shared operands for ``batch``
    samples (arguments as its own) and ask the library for the launch's
    shared memory, once: ``ParameterSweep`` builds its plan with the
    program, so a step's launch pays neither."""
    n_tiles = dest_offsets.shape[0] - 1
    n_blocks, tile = weights.shape[-3], weights.shape[-2]
    shape = (batch, n_tiles, tile)
    plan = dict(weights=weights, arrivals=arrivals, src_tiles=src_tiles,
                dest_offsets=dest_offsets,
                max_blocks_per_dest=int(max_blocks_per_dest),
                live_rows=live_rows, shape=shape, launch=None,
                arrived_bytes=0, scratch_bytes=0)
    dev = weights.device
    if dev.type == "cpu":
        return BatchDelivery(**plan)
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
    if n_blocks * tile >= 2**31:
        raise ValueError("delivery_batch_kernel: the kernel indexes weight "
                         "rows with int32; 2**31 or more rows")
    if not isinstance(live_rows, LiveRows):
        raise ValueError("delivery_batch_kernel: live_rows must be a "
                         "LiveRows (build_live_rows)")
    n_live = live_rows.rows.numel()
    if n_live % 16 or not 0 <= live_rows.count <= min(n_live,
                                                      n_blocks * tile):
        raise ValueError(
            f"delivery_batch_kernel: live_rows lists {live_rows.count} rows "
            f"in {n_live} bytes for {n_blocks} blocks of {tile} rows")
    words = -(-tile // 32)
    w_shape = (n_blocks, tile, tile)
    a_shape = (n_blocks, tile, words)
    if weights.dim() == 4:
        w_shape = (batch,) + w_shape
    if arrivals.dim() == 4:
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
    w_stride = n_blocks * tile * tile if weights.dim() == 4 else 0
    a_stride = n_blocks * tile * words if arrivals.dim() == 4 else 0
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


def delivery_batch_launch(fired_tiles, plan: BatchDelivery):
    """``delivery_batch_kernel`` on ``plan``'s operands: the CUDA kernels
    for CUDA planes, ``delivery_batch_plain`` for CPU ones. Checks only the
    planes ``fired_tiles`` ([B, n_tiles, tile], the plan's shape, in the
    weights' dtype), allocates the outputs and launches on the current
    stream; counts on ``delivery_batch_kernel.launches``."""
    dev = fired_tiles.device
    if dev.type == "cpu":
        return delivery_batch_plain(
            fired_tiles, plan.weights, plan.arrivals, plan.src_tiles,
            plan.dest_offsets, plan.max_blocks_per_dest, plan.live_rows)
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
    sums) for CUDA tensors, ``delivery_batch_plain`` for CPU tensors.
    Arguments and results as ``delivery_batch_plain``'s, and ``live_rows``
    (``build_live_rows`` of these weights and arrivals, or a list with more
    rows, such as ``every_row_live``). It checks every operand on each
    call; a caller that launches on the same operands step after step
    builds ``plan_delivery_batch`` once and calls ``delivery_batch_launch``.

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
    if dev.type == "cpu":
        return delivery_batch_plain(fired_tiles, weights, arrivals,
                                    src_tiles, dest_offsets,
                                    max_blocks_per_dest, live_rows)
    if dev.type != "cuda":
        raise ValueError(f"delivery_batch_kernel: unsupported device {dev}")
    if fired_tiles.dim() != 3 or fired_tiles.shape[0] == 0:
        raise ValueError("delivery_batch_kernel: fired_tiles must be "
                         "[B, n_tiles, tile] with B > 0")
    plan = plan_delivery_batch(fired_tiles.shape[0], weights, arrivals,
                               src_tiles, dest_offsets, max_blocks_per_dest,
                               live_rows)
    return delivery_batch_launch(fired_tiles, plan)


delivery_batch_kernel.launches = 0
