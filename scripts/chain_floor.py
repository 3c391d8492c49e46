"""Kernels the probes build beside the package's: the chain floors, and the
prefix and level kernels of another checkout.

- ``prefix_floor(rows, cols)`` / ``level_floor(args)``: a function that
  launches ``scripts/chain_floor.cu``'s recurrence run from registers once
  (N dependent float64 adds a row; T steps of ``lif_step`` a lane, with
  ``args`` the level kernel's arguments). Its time on the card (the
  caller's CUDA events) is the least the prefix and level kernels' chains
  allow, whatever their memory traffic.
- ``other_library(root, name)``: ``<root>/sanafe_tpu_torch/csrc/<name>_
  kernel.cu`` (an unpacked older commit, say) built with the package's
  flags and loaded; ``using(root, name)`` makes the package's wrapper launch
  it, so two commits' kernels run in turns in one process, on one card
  (``prefix`` and ``level``).

Used by ``scripts/prefix_probe.py``, ``scripts/dvs_probe.py`` and
``chip_smoke.py``; builds go to
``sanafe_tpu_torch/build/``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "sanafe_tpu_torch" / "build"


@dataclass(frozen=True)
class Library:
    """A CUDA source outside the package and the library built from it
    (what ``sanafe_tpu_torch.ops.cuda_build.build`` takes)."""

    source: Path
    path: Path
    headers: Path  # the directory of the headers it includes

    @property
    def log(self) -> Path:
        return self.path.with_suffix(".log")

    def stale(self) -> bool:
        inputs = [self.source, *self.headers.glob("*.cuh")]
        newest = max(path.stat().st_mtime for path in inputs)
        return not (self.path.exists() and self.path.stat().st_mtime
                    >= newest)


FLOOR = Library(ROOT / "scripts" / "chain_floor.cu",
                BUILD / "libsanafe_chain_floor.so",
                ROOT / "sanafe_tpu_torch" / "csrc")


@functools.cache
def floor_library() -> ctypes.CDLL:
    from sanafe_tpu_torch.ops import cuda_build

    cuda_build.build(FLOOR)
    lib = ctypes.CDLL(str(FLOOR.path))
    lib.chain_floor_prefix.restype = ctypes.c_int
    lib.chain_floor_prefix.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.chain_floor_level.restype = ctypes.c_int
    lib.chain_floor_level.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return lib


def _check(err: int) -> None:
    if err:
        raise RuntimeError(f"chain floor launch failed (CUDA error {err})")


def prefix_floor(rows: int, cols: int):
    """A launcher of ``rows`` chains of ``cols`` dependent float64 adds,
    one lane a row."""
    import torch

    lib = floor_library()
    x = torch.rand((rows, 2), dtype=torch.float64, device="cuda") * 1e-8
    out = torch.empty(rows, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _check(lib.chain_floor_prefix(x.data_ptr(), out.data_ptr(), rows,
                                      cols, stream))

    return run


def level_floor(args):
    """A launcher of one level's chains: ``args`` are the level kernel's
    arguments (``params, v0, u0, r0, cur_seq, val_seq, add_seq, t0,
    ...``); each lane runs ``cur_seq.shape[0]`` steps of ``lif_step`` from
    registers."""
    import torch

    from sanafe_tpu_torch.ops.level_scan import PARAM_KEYS

    params, v0, u0, r0, cur_seq, val_seq, add_seq = args[:7]
    steps, size = cur_seq.shape
    lib = floor_library()
    state = [torch.empty_like(v0), torch.empty_like(u0), torch.empty_like(r0)]
    tensors = [params[key] for key in PARAM_KEYS] + [
        v0, u0, r0, cur_seq, val_seq, add_seq, None, None, None, None,
        *state]
    ptrs = torch.tensor([0 if x is None else x.data_ptr() for x in tensors],
                        dtype=torch.int64, device=v0.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _check(lib.chain_floor_level(ptrs.data_ptr(), size, steps,
                                     int(add_seq is not None), stream))

    return run


def other_library(root: Path, name: str) -> Library:
    """``name``'s kernel source under the checkout ``root``, built beside
    the package's libraries (``build`` it first)."""
    root = Path(root).resolve()
    csrc = root / "sanafe_tpu_torch" / "csrc"
    tag = root.name.replace(" ", "_")
    return Library(csrc / f"{name}_kernel.cu",
                   BUILD / f"libsanafe_{name}_{tag}.so", csrc)


@contextlib.contextmanager
def using(root: Path, name: str):
    """Within the block, the package's ``prefix`` or ``level`` wrapper
    launches the kernel built from ``root``'s source (same C interface)."""
    from sanafe_tpu_torch.ops import cuda_build, device_sweep, level_scan

    lib_file = other_library(root, name)
    cuda_build.build(lib_file)
    module, attr, functions = {
        "prefix": (device_sweep, "_prefix_library", (
            "sanafe_prefix_launch", "sanafe_prefix_error_string")),
        "level": (level_scan, "_library", (
            "sanafe_level_launch", "sanafe_level_error_string")),
    }[name]
    ours = getattr(module, attr)
    lib = ctypes.CDLL(str(lib_file.path))
    mine = ours()
    for function in functions:
        getattr(lib, function).restype = getattr(mine, function).restype
        getattr(lib, function).argtypes = getattr(mine, function).argtypes
    setattr(module, attr, lambda: lib)
    try:
        yield lib
    finally:
        setattr(module, attr, ours)
