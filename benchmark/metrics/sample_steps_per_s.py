"""Samples x timesteps of every sweep run completed in the window over the
window's wall time."""


def read(run: dict):
    return sum(c.steps * c.samples for c in run["calls"]) / run["window_s"]
