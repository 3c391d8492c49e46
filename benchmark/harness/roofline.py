"""Rooflines from the traced window: the least time the card could take
for the work these inputs need, over the kernel's profiler time.

The least time of a launch is the larger of its bytes over the HBM
bandwidth and its operations over the float32 peak (NVIDIA H100 SXM, the
data sheet's dense rates at 700 W). The bytes count what the inputs need,
each byte once, whatever the kernel's layout reads: the counts are worked
out from the cell's description and the reference's raster, never from
the program's arrays."""

import re

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S)


def kernel_seconds(run: dict, symbols, counted: str, wrapper: str):
    """The profiler's seconds in the kernels named ``symbols`` (whole words
    of the demangled name) over the traced window, or None where the
    profiler's count of ``counted`` differs from the launches that the
    program's wrapper ``wrapper`` (``"module:function"``) counted (a kernel
    the profiler lost): not measured."""
    trace = run["trace"]
    if not trace or not trace["busy_s"]:
        return None
    seconds, count = 0.0, 0
    for name, (s, n) in trace["ops"].items():
        for symbol in symbols:
            if re.search(rf"\b{symbol}\b", name):
                seconds += s
                if symbol == counted:
                    count += n
    launches = trace["launches"].get(wrapper, 0)
    if launches == 0 or count != launches or seconds <= 0:
        return None
    return seconds


def share_pct(least: float, seconds) -> float:
    return None if seconds is None else 100.0 * least / seconds
