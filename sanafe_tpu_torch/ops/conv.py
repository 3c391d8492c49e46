"""Structured conv2d spike delivery: one strided convolution per hyperedge.

Counterpart of ``ConvDelivery`` / ``build_conv_delivery`` and
``_conv_deliver`` in ``sanafe_tpu/ops/step.py``. A chip described with
conv2d hyperedges (``compile.py:ConvSpec``) keeps its flat edge arrays for
axons, counters and timing, but its message phase runs each hyperedge as ONE
strided convolution over the source group's fired plane: the reference's
neuron indexing (src/network.cpp:377-528, ``ci*W*H + y*W + x``) makes a
group's slots an NCHW plane. An extra all-ones output channel makes the same
convolution yield each destination's arrival count, whose positivity is the
reference's ``buffer_valid`` (src/chip.cpp:656-708). Edges no conv spec
covers (a dense classifier head) keep block delivery over just those edges
(the program's ``block``).

sanafe_tpu keeps each filter HWIO, ``[kh, kw, cin, cout + 1]``; PyTorch's
layout is OIHW, so the program holds the same filter permuted,
``[cout + 1, cin, kh, kw]``. The convolution (stride as in the spec, no
padding) stands where XLA computes ``lax.conv_general_dilated`` outside any
Pallas kernel, at ``Precision.HIGHEST``. It runs as im2col (one copy of a
strided view of the input) and one float32 product with TF32 off
(``full_float32_matmul``): on an H100 (700 W), cuDNN's float32
``conv2d`` with TF32 off picked an algorithm that was not exact on the DVS
net's 32 -> 64 channel layer (4.9e-4 off a float64 reference on 1/64-grid
weights) and broke the raster, while the product of 0/1 planes with
1/64-grid weights is exact in float32 in any order.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..compile import CompiledChip


@dataclass
class ConvDelivery:
    """The structured delivery plan of a chip's conv2d hyperedges."""

    # per conv spec: (src_group, dest_group, kernel f64 [kh, kw, cin, cout+1]
    # HWIO with the all-ones count channel, (s_h, s_w), (cin, h, w),
    # (cout, oh, ow))
    entries: list
    # source group -> int32 slots: the group's fired plane in neuron-offset
    # order is one gather
    in_index: dict
    # conv-dest groups in the order their results concatenate into G
    dest_order: list
    # slot s takes G[out_gidx[s]] where out_mask[s], else 0: the inverse slot
    # permutation as one gather
    out_gidx: np.ndarray  # int32 [n]
    out_mask: np.ndarray  # bool [n]


def build_conv_delivery(c: CompiledChip) -> Optional[ConvDelivery]:
    """The structured delivery plan, or None where it does not apply: no
    conv specs, or a dendrite with per-edge state (delay slots, taps,
    plugin compartments). sanafe_tpu's ``build_conv_delivery`` without its
    ``leftover`` block, which the program builds as its ``block``."""
    specs = getattr(c, "conv_specs", None)
    if not specs:
        return None
    if c.has_delay_dendrite or c.has_multitap or c.has_plugin_comp:
        return None
    if getattr(c, "edge_from_conv", None) is None:
        return None

    entries = []
    in_index: dict[str, np.ndarray] = {}
    for spec in specs:
        out_h = (spec.in_h - spec.k_h) // spec.s_h + 1
        out_w = (spec.in_w - spec.k_w) // spec.s_w + 1
        kernel = np.concatenate(
            [spec.kernel,
             np.ones((spec.k_h, spec.k_w, spec.in_c, 1), dtype=np.float64)],
            axis=3,
        )
        entries.append((
            spec.src_group, spec.dest_group, kernel, (spec.s_h, spec.s_w),
            (spec.in_c, spec.in_h, spec.in_w), (spec.out_c, out_h, out_w),
        ))
        if spec.src_group not in in_index:
            in_index[spec.src_group] = np.asarray(
                c.groups[spec.src_group], dtype=np.int32)

    # only conv-dest groups contribute values; every other slot is masked to
    # zero (non-conv edges arrive through the block path, added on top)
    dest_order = sorted({e[1] for e in entries})
    base, off = {}, 0
    for g in dest_order:
        base[g] = off
        off += len(c.groups[g])
    out_gidx = np.zeros(c.n_neurons, dtype=np.int32)
    out_mask = np.zeros(c.n_neurons, dtype=bool)
    for g in dest_order:
        slots = np.asarray(c.groups[g])
        out_gidx[slots] = base[g] + np.arange(len(slots), dtype=np.int32)
        out_mask[slots] = True
    return ConvDelivery(entries=entries, in_index=in_index,
                        dest_order=dest_order, out_gidx=out_gidx,
                        out_mask=out_mask)


def hwio_to_oihw(kernel: torch.Tensor) -> torch.Tensor:
    """sanafe_tpu's conv filter layout, HWIO ``[..., kh, kw, cin, cout+1]``
    (count channel last), as the port holds it: OIHW ``[..., cout+1, cin,
    kh, kw]``, contiguous. Leading axes (a sweep's samples) stay."""
    return kernel.movedim((-1, -2), (-4, -3)).contiguous()


def conv_arrays(cd: ConvDelivery, dtype: torch.dtype, device) -> dict:
    """The program arrays of the plan: ``conv_kernel_{i}`` (OIHW, the HWIO
    filter permuted by ``hwio_to_oihw``), ``conv_src_idx_{i}``,
    ``conv_out_gidx`` and ``conv_out_mask``, under sanafe_tpu's names."""
    arrays = {}
    for i, entry in enumerate(cd.entries):
        arrays[f"conv_kernel_{i}"] = hwio_to_oihw(
            torch.from_numpy(entry[2])).to(device=device, dtype=dtype)
        arrays[f"conv_src_idx_{i}"] = torch.from_numpy(
            cd.in_index[entry[0]]).to(device)
    arrays["conv_out_gidx"] = torch.from_numpy(cd.out_gidx).to(device)
    arrays["conv_out_mask"] = torch.from_numpy(cd.out_mask).to(device)
    return arrays


@contextlib.contextmanager
def full_float32_matmul():
    """Products in full float32, as XLA runs them: TF32 stays off for their
    duration (the roll-up and one-hot products of both engines, and the
    convolutions)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def conv_entry(a: dict, i: int, entry: tuple, x: torch.Tensor):
    """Entry ``i`` of the plan over a batch of source planes: ``x``
    ``[B, cin*h*w]`` (the source group's fired vectors in neuron-offset
    order). Returns (currents, arrival counts), each ``[B, cout*oh*ow]`` in
    the destination group's neuron order. A filter with a leading ``[B]``
    axis (a sweep's per-sample filters) convolves row b with filter b: a
    batched product."""
    _, _, kernel, (s_h, s_w), (cin, h, w), (cout, oh, ow) = entry
    k_h, k_w = kernel.shape[:2]
    rows = x.shape[0]
    weights = a[f"conv_kernel_{i}"]
    # [B, cin*kh*kw, oh*ow] columns, channel-major like the OIHW rows: one
    # copy of a strided view (F.unfold launches one im2col per batch row
    # on CUDA: 4,000 launches for the DVS net's 1000-step chunk)
    patches = x.reshape(rows, cin, h, w).unfold(2, k_h, s_h).unfold(
        3, k_w, s_w)  # [B, cin, oh, ow, kh, kw]
    cols = patches.permute(0, 1, 4, 5, 2, 3).reshape(
        rows, cin * k_h * k_w, oh * ow)
    with full_float32_matmul():
        y = torch.matmul(weights.flatten(-3), cols)
    cur = y[:, :cout].reshape(rows, -1)
    cnt = y[:, cout:cout + 1].expand(rows, cout, oh * ow).reshape(rows, -1)
    return cur, cnt


def conv_results(cd: ConvDelivery, a: dict, entries, planes):
    """Sum the entries ``entries`` (indices into ``cd.entries``) per
    destination group. ``planes(i)`` gives entry ``i``'s source planes
    ``[B, cin*h*w]``. Returns {dest group: (currents, counts)}."""
    results: dict[str, tuple] = {}
    for i in entries:
        entry = cd.entries[i]
        cur, cnt = conv_entry(a, i, entry, planes(i))
        dst = entry[1]
        if dst in results:
            pc, pn = results[dst]
            results[dst] = (pc + cur, pn + cnt)
        else:
            results[dst] = (cur, cnt)
    return results


def conv_deliver(prog, a: dict, fired_f: torch.Tensor):
    """One step of conv delivery (sanafe_tpu's ``_conv_deliver``): returns
    (buffer_current [n], any_input [n] bool) of the conv-made edges only,
    or ``[B, n]`` each for a ``[B, n]`` batch of fired vectors (one row of
    the convolutions' batch a sample)."""
    cd = prog.conv_delivery
    lead = fired_f.shape[:-1]
    rows = fired_f.reshape(-1, fired_f.shape[-1])
    results = conv_results(
        cd, a, range(len(cd.entries)),
        lambda i: rows[:, a[f"conv_src_idx_{i}"]])
    g_cur = torch.cat([results[g][0] for g in cd.dest_order], dim=1)
    g_cnt = torch.cat([results[g][1] for g in cd.dest_order], dim=1)
    mask = a["conv_out_mask"]
    gidx = a["conv_out_gidx"]
    zero = torch.zeros((), dtype=fired_f.dtype, device=fired_f.device)
    buffer_current = torch.where(mask, g_cur[:, gidx], zero)
    any_input = mask & (g_cnt[:, gidx] > 0)
    return (buffer_current.reshape(lead + (-1,)),
            any_input.reshape(lead + (-1,)))
