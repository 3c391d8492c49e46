"""Activity-gated block-dense spike delivery.

Counterpart of ``sanafe_tpu/ops/pallas_delivery.py`` and of the delivery
part of ``sanafe_tpu/ops/step.py:_block_deliver``. Per timestep, for each
destination tile, the sum over its blocks (sorted dest-major, as
``build_block_delivery`` gives them) of ``x[src_tile] @ W[block]``, where
``x`` is the 0/1 fired vector cut into ``[n_tiles, tile]``; and in the same
pass the sum of ``x[src_tile] @ counts[block]`` in int32, whose positivity
is the reference's "message arrived" condition.

``delivery_plain`` is the einsum + sorted segment sum and the count product
of sanafe_tpu (``ops/step.py:1580-1608``) in PyTorch, for any device;
``delivery_kernel`` is the wrapper of ``csrc/delivery_kernel.cu``, which
takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import functools

import torch

from .cuda_build import DELIVERY, load

# the kernel's CTA width: a tile is at most this many neurons
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


@functools.cache
def _library():
    import ctypes

    lib = load(DELIVERY)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sanafe_delivery_launch.restype = i32
    lib.sanafe_delivery_launch.argtypes = [vp] * 7 + [i32] * 4 + [vp]
    lib.sanafe_delivery_error_string.restype = ctypes.c_char_p
    lib.sanafe_delivery_error_string.argtypes = [i32]
    return lib


def delivery_kernel(fired_tiles, weights, counts, src_tiles, dest_offsets,
                    max_blocks_per_dest: int):
    """One delivery: the CUDA kernel for CUDA tensors, ``delivery_plain``
    for CPU tensors. Same arguments and results as ``delivery_plain``.

    The kernel runs float32 and float64, launches on the current stream and
    does not synchronise. ``delivery_kernel.launches`` counts its
    launches."""
    dev = fired_tiles.device
    if dev.type == "cpu":
        return delivery_plain(fired_tiles, weights, counts, src_tiles,
                              dest_offsets, max_blocks_per_dest)
    if dev.type != "cuda":
        raise ValueError(f"delivery_kernel: unsupported device {dev}")
    dtype = fired_tiles.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"delivery_kernel: unsupported dtype {dtype}")
    if fired_tiles.dim() != 2:
        raise ValueError("delivery_kernel: fired_tiles must be [n_tiles, tile]")
    n_tiles, tile = fired_tiles.shape
    n_blocks = weights.shape[0]
    if not 0 < tile <= MAX_TILE:
        raise ValueError(f"delivery_kernel: tile {tile} exceeds {MAX_TILE}")
    expect = {
        "fired_tiles": (fired_tiles, (n_tiles, tile), dtype),
        "weights": (weights, (n_blocks, tile, tile), dtype),
        "counts": (counts, (n_blocks, tile, tile), torch.int8),
        "src_tiles": (src_tiles, (n_blocks,), torch.int32),
        "dest_offsets": (dest_offsets, (n_tiles + 1,), torch.int32),
    }
    for name, (x, shape, dt) in expect.items():
        if (x.device != dev or tuple(x.shape) != shape or x.dtype != dt
                or not x.is_contiguous()):
            raise ValueError(
                f"delivery_kernel: {name} must be a contiguous {dt} tensor "
                f"of shape {shape} on {dev}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
            )
    out_cur = torch.empty((n_tiles, tile), dtype=dtype, device=dev)
    out_cnt = torch.empty((n_tiles, tile), dtype=torch.int32, device=dev)
    lib = _library()
    err = lib.sanafe_delivery_launch(
        fired_tiles.data_ptr(), weights.data_ptr(), counts.data_ptr(),
        src_tiles.data_ptr(), dest_offsets.data_ptr(), out_cur.data_ptr(),
        out_cnt.data_ptr(), n_tiles, tile, int(dtype == torch.float64),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            "delivery kernel launch failed: "
            + lib.sanafe_delivery_error_string(err).decode()
        )
    delivery_kernel.launches += 1
    return out_cur, out_cnt


delivery_kernel.launches = 0
