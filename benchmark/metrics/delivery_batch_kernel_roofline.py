"""The sample-batched delivery kernel (csrc/delivery_batch_kernel.cu,
`mask_kernel` and `batch_kernel` a launch) against its roofline, one
launch a step of a sweep. A step's work: 4 B of weight and 4 B of
destination index for each edge out of a neuron that fired in any sample,
read once for all samples, and for every sample its fired plane read (a
bit a neuron) and its currents (4 B a neuron) and arrival flags (a bit a
neuron) written; an add for each sample's fired edge."""

import numpy as np

from benchmark.harness import roofline

# the program's wrapper, whose launch counter the run reads
WRAPPER = "sanafe_tpu_torch.ops.delivery:delivery_batch_kernel"
SYMBOLS = ("batch_kernel", "mask_kernel")


def read(run: dict):
    seconds = roofline.kernel_seconds(run, SYMBOLS, "batch_kernel",
                                      WRAPPER)
    if seconds is None:
        return None
    layout = run["layout"]
    n = layout.n
    least = 0.0
    for fired in run["rasters"]:  # [steps, samples, neurons]
        samples = fired.shape[1]
        union = fired.any(axis=1).astype(np.float64) @ layout.fanout
        adds = fired.sum(axis=1).astype(np.float64) @ layout.fanout
        for u, a in zip(union, adds):
            least += roofline.least_s(
                8.0 * u + samples * (n / 8 + 4.0 * n + n / 8), a)
    return roofline.share_pct(least, seconds)
