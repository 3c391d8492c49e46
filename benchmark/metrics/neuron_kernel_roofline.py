"""The step scan's neuron kernel (csrc/neuron_kernel.cu, `neuron_kernel`)
against its roofline, one launch a step: the LIF update and the stats row.
A step's work: the potential, input current and refractory count read and
written (24 B a neuron), the current read (4 B), the arrival, fired and
updated flags (a bit each a neuron), and one latency (4 B) a message of a
neuron that fired; no float operation counted.

A program without the kernel (an older checkout) names no wrapper, and the
metric reads nothing there."""

import importlib.util

from benchmark.harness import roofline


def _wrapper():
    try:
        found = importlib.util.find_spec("sanafe_tpu_torch.ops.neuron")
    except ModuleNotFoundError:
        found = None
    return None if found is None else \
        "sanafe_tpu_torch.ops.neuron:neuron_kernel"


# the program's wrapper, whose launch counter the run reads
WRAPPER = _wrapper()
SYMBOLS = ("neuron_kernel",)


def read(run: dict):
    if WRAPPER is None:
        return None
    seconds = roofline.kernel_seconds(run, SYMBOLS, "neuron_kernel",
                                      WRAPPER)
    if seconds is None:
        return None
    layout = run["layout"]
    n = layout.n
    least = 0.0
    for fired in run["rasters"]:
        for messages in fired.astype(float) @ layout.n_axons:
            least += roofline.least_s(28.0 * n + 3 * n / 8 + 4.0 * messages,
                                      0.0)
    return roofline.share_pct(least, seconds)
