"""Simulated timesteps of every call completed in the window over the
window's wall time. One reader for ``steps_per_s`` and every
``steps_per_s.<part>`` (``.detailed``: under detailed timing, whose host
sweep spreads more and takes a bound of its own)."""


def read(run: dict):
    return sum(c.steps for c in run["calls"]) / run["window_s"]
