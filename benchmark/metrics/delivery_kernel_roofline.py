"""The single-chip delivery kernel (csrc/delivery_kernel.cu, `live_kernel`)
against its roofline, one launch a step. A step's work: 4 B of weight and
4 B of destination index for each edge out of a neuron that fired, the
fired plane read (a bit a neuron), and the currents (4 B a neuron in
float32) and the arrival flags (a bit a neuron) written; an add an edge."""

import numpy as np

from benchmark.harness import roofline

# the program's wrapper, whose launch counter the run reads
WRAPPER = "sanafe_tpu_torch.ops.delivery:delivery_kernel"
SYMBOLS = ("live_kernel",)


def read(run: dict):
    seconds = roofline.kernel_seconds(run, SYMBOLS, "live_kernel",
                                      WRAPPER)
    if seconds is None:
        return None
    layout = run["layout"]
    n = layout.n
    least = 0.0
    for fired in run["rasters"]:
        edges = fired.astype(np.float64) @ layout.fanout
        for e in edges:
            least += roofline.least_s(8.0 * e + n / 8 + 4.0 * n + n / 8, e)
    return roofline.share_pct(least, seconds)
