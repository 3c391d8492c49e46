"""The DAG engine's level kernel (csrc/level_kernel.cu, `level_kernel`)
against its roofline, one launch a level and chunk. A launch's work, for
each of its level's neurons (lanes): the input current read (4 B in
float32) and the spike bit written for each step, and the seven LIF
parameters (threshold, reset, reverse threshold and reset, leak and input
decay, bias: 4 B each) read and the state (potential, input current,
refractory count: 4 B each) read and written once; eight operations a
lane-step (two decays, the quantisation's three, the bias and current
adds, the threshold test). A level is a group of the description."""

from benchmark.harness import roofline

# the program's wrapper, whose launch counter the run reads
WRAPPER = "sanafe_tpu_torch.ops.level_scan:level_kernel"
SYMBOLS = ("level_kernel",)


def read(run: dict):
    seconds = roofline.kernel_seconds(run, SYMBOLS, "level_kernel",
                                      WRAPPER)
    if seconds is None:
        return None
    least = 0.0
    for call in run["calls"]:
        for g in run["desc"]["groups"]:
            lanes = g["n"]
            lane_steps = lanes * call.steps
            least += roofline.least_s(
                lane_steps * (4.0 + 1.0 / 8) + lanes * (7 * 4 + 2 * 3 * 4),
                8.0 * lane_steps)
    return roofline.share_pct(least, seconds)
