"""Build the port's CUDA kernels and load them with ctypes.

Each kernel source ``csrc/<name>_kernel.cu`` has a plain C interface and is
compiled by ``nvcc`` (sm_90a) into ``build/libsanafe_<name>.so`` at first
use, or when the source is newer than the library. ``build`` starts one
``nvcc`` per stale source, all at once, and waits for them all. The
compiler's resource report (registers, shared memory, spills) is kept beside
each library in ``build/libsanafe_<name>.log``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_BUILD_DIR = _PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: u*decay + cur and v*leak + ... must round as two
    # operations, as in the JAX code and the plain versions; never
    # --use_fast_math, which would also break the Kahan compensation
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]


@dataclass(frozen=True)
class KernelLibrary:
    """One kernel source and the shared library built from it."""

    name: str

    @property
    def source(self) -> Path:
        return _PKG_DIR / "csrc" / f"{self.name}_kernel.cu"

    @property
    def path(self) -> Path:
        return _BUILD_DIR / f"libsanafe_{self.name}.so"

    @property
    def log(self) -> Path:
        return self.path.with_suffix(".log")

    def stale(self) -> bool:
        return not (self.path.exists() and self.path.stat().st_mtime
                    >= self.source.stat().st_mtime)


CHUNK = KernelLibrary("chunk")
DELIVERY = KernelLibrary("delivery")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
            "kernels are built from sanafe_tpu_torch/csrc/ at first use"
        )
    return str(path)


def build(*libraries: KernelLibrary) -> float:
    """Compile every stale library in parallel; returns the wall seconds
    spent (0 when all are up to date). Each build writes a per-process
    temporary file and renames it into place, so processes that build at
    the same time never load a half-written library."""
    stale = [lib for lib in libraries if lib.stale()]
    if not stale:
        return 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    running = []
    for lib in stale:
        tmp = lib.path.with_name(f"{lib.path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(lib.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((lib, tmp, proc))
    failures = []
    for lib, tmp, proc in running:
        out, err = proc.communicate()
        lib.log.write_text(out + err)
        if proc.returncode:
            failures.append(f"{lib.source.name} ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, lib.path)
    if failures:
        raise RuntimeError("nvcc failed: " + "\n".join(failures))
    return time.perf_counter() - start


def load(lib: KernelLibrary) -> ctypes.CDLL:
    """Build ``lib`` if it is stale and load it."""
    build(lib)
    return ctypes.CDLL(str(lib.path))
