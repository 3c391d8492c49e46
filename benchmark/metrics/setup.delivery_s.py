"""The part of the cell's set-up that built the program's block delivery
(on the delivery kernel's path, the live rows straight from the edges), in
seconds on the host's clock: the ``sanafe.setup.delivery`` spans that
ended before the first timed call (``sanafe_tpu_torch.tracing.setups()``;
they feed the chip's ``delivery_build_wall``), summed. None for a program
that keeps no such span."""


def read(run: dict):
    try:
        from sanafe_tpu_torch import tracing
    except ImportError:
        return None
    setups = getattr(tracing, "setups", None)
    if setups is None:
        return None
    opened = int(run["calls"][0].begin * 1e9)
    built = [s for s in setups() if s.name == "sanafe.setup.delivery"
             and s.end_ns <= opened]
    if not built:
        return None
    return 1e-9 * sum(s.end_ns - s.start_ns for s in built)
