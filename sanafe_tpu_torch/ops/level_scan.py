"""The membrane recurrence of one level of the feed-forward (DAG) engine.

The DAG engine (``ops/dag_chunk.py``) computes a level's input for a whole
chunk at once; what remains sequential is each lane's LIF update over the
chunk's T steps. sanafe_tpu runs it as a ``lax.scan`` of ``_lif_update``
(``sanafe_tpu/ops/dag_chunk.py:373-386``), which XLA compiles into one loop.

``level_plain`` is that recurrence in plain PyTorch: a Python loop of
``ops/step.py:lif_step`` over the steps, on any device and dtype.
``level_kernel`` is the wrapper of ``csrc/level_kernel.cu``: one launch a
level, a lane's state in registers, one warp of a CTA running the
recurrence of 32 lanes while the other feeds it the input rows and stores
the fired and updated rows; on CPU tensors it takes the plain version.

Both take the level's parameter vectors ``params`` (``bias``,
``leak_decay``, ``input_decay``, ``threshold``, ``reverse_threshold``,
``reset``, ``reverse_reset``, ``refractory_delay``, ``reset_mode``,
``reverse_reset_mode``, ``force_update``; ``[size]`` each), the state
before the chunk (``v0``, ``u0``, ``r0``), the ``[T, size]`` input planes
(``cur_seq`` currents, ``val_seq`` arrivals, ``add_seq`` the LIF noise or
None) and the 1-based step ``t0`` of row 0: an int, or a 0-d int64 tensor
on the level's device, which the kernel reads on the card, so that a CUDA
graph that captured its launch (``ops/dag_chunk.py:DagGraphs``) replays it
for whatever step the tensor then holds. They return ``LevelOut``: the
fired and updated planes ``[T, size]`` (bool), the potential and input
current after every step (``[T, size]``, only where asked for) and the
state after the last step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .cuda_build import LEVEL, load
from .step import lif_step

PARAM_KEYS = (
    "bias", "leak_decay", "input_decay", "threshold", "reverse_threshold",
    "reset", "reverse_reset", "refractory_delay", "reset_mode",
    "reverse_reset_mode", "force_update",
)


class LevelOut(NamedTuple):
    fired: torch.Tensor  # [T, size] bool
    updated: torch.Tensor  # [T, size] bool
    v_seq: Optional[torch.Tensor]  # [T, size] or None
    u_seq: Optional[torch.Tensor]  # [T, size] or None
    v: torch.Tensor  # [size], after the last step
    u: torch.Tensor
    refractory: torch.Tensor  # [size] int32


def level_plain(params: dict, v0, u0, r0, cur_seq, val_seq, add_seq,
                t0, record_v: bool = False,
                record_u: bool = False) -> LevelOut:
    """Plain PyTorch version of the level kernel (module docstring)."""
    v, u, r = v0, u0, r0
    fired, updated, v_seq, u_seq = [], [], [], []
    for j in range(cur_seq.shape[0]):
        noise = None if add_seq is None else add_seq[j]
        v, u, r, upd, f = lif_step(params, v, u, r, val_seq[j], cur_seq[j],
                                   t0 + j, noise)
        fired.append(f)
        updated.append(upd)
        v_seq.append(v)
        u_seq.append(u)

    def stack(rows, like):
        return torch.stack(rows) if rows else like.new_zeros((0,) + like.shape)

    return LevelOut(
        stack(fired, val_seq), stack(updated, val_seq),
        stack(v_seq, v0) if record_v else None,
        stack(u_seq, u0) if record_u else None,
        v, u, r,
    )


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(LEVEL)
    lib.sanafe_level_launch.restype = ctypes.c_int
    lib.sanafe_level_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sanafe_level_error_string.restype = ctypes.c_char_p
    lib.sanafe_level_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(name, x, shape, dtype, device):
    if (x.device != device or tuple(x.shape) != tuple(shape)
            or x.dtype != dtype or not x.is_contiguous()):
        raise ValueError(
            f"level_kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}"
        )


def level_kernel(params: dict, v0, u0, r0, cur_seq, val_seq, add_seq,
                 t0, record_v: bool = False,
                 record_u: bool = False) -> LevelOut:
    """The level recurrence: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Same arguments and result as ``level_plain``.

    The kernel runs float32 only; it launches on the current stream and
    does not synchronise. ``level_kernel.launches`` counts its launches."""
    dev = v0.device
    if dev.type == "cpu":
        return level_plain(params, v0, u0, r0, cur_seq, val_seq, add_seq,
                           t0, record_v, record_u)
    if dev.type != "cuda":
        raise ValueError(f"level_kernel: unsupported device {dev}")
    if v0.dtype != torch.float32:
        raise NotImplementedError(
            "level_kernel runs float32 only (the DAG engine's dtype)")
    f32, i32 = torch.float32, torch.int32
    size = v0.shape[0]
    steps = cur_seq.shape[0]
    for key in PARAM_KEYS:
        dtype = (i32 if key in ("refractory_delay", "reset_mode",
                                "reverse_reset_mode")
                 else torch.bool if key == "force_update" else f32)
        _check(key, params[key], (size,), dtype, dev)
    _check("v0", v0, (size,), f32, dev)
    _check("u0", u0, (size,), f32, dev)
    _check("r0", r0, (size,), i32, dev)
    _check("cur_seq", cur_seq, (steps, size), f32, dev)
    _check("val_seq", val_seq, (steps, size), torch.bool, dev)
    if add_seq is not None:
        _check("add_seq", add_seq, (steps, size), f32, dev)
    if not isinstance(t0, torch.Tensor):
        # a fill, not a copy from the host: no synchronisation
        t0 = torch.full((), int(t0), dtype=torch.int64, device=dev)
    _check("t0", t0, (), torch.int64, dev)

    fired = torch.empty((steps, size), dtype=torch.bool, device=dev)
    updated = torch.empty((steps, size), dtype=torch.bool, device=dev)
    v_seq = (torch.empty((steps, size), dtype=f32, device=dev)
             if record_v else None)
    u_seq = (torch.empty((steps, size), dtype=f32, device=dev)
             if record_u else None)
    v = torch.empty(size, dtype=f32, device=dev)
    u = torch.empty(size, dtype=f32, device=dev)
    r = torch.empty(size, dtype=i32, device=dev)
    tensors = [params[key] for key in PARAM_KEYS] + [
        v0, u0, r0, cur_seq, val_seq, add_seq,
        fired, updated, v_seq, u_seq, v, u, r,
    ]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if x is None else x.data_ptr() for x in tensors])
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sanafe_level_launch(ptrs, size, steps, t0.data_ptr(),
                                  dev.index or 0, stream)
    if err:
        raise RuntimeError("level kernel launch failed: "
                           + lib.sanafe_level_error_string(err).decode())
    level_kernel.launches += 1
    return LevelOut(fired, updated, v_seq, u_seq, v, u, r)


level_kernel.launches = 0
