"""The native host sweep of detailed timing: the change of the chip's
scheduler_wall over the traced window, per simulated step."""


def read(run: dict):
    steps = sum(c.steps for c in run["calls"])
    return 1e3 * run["trace"]["walls"]["scheduler"] / steps
