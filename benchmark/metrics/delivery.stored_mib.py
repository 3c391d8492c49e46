"""The bytes of the block delivery's device arrays in the program the
cell's set-up built, in MiB: the field ``delivery.stored_bytes`` of the
newest ``sanafe.setup.delivery`` span that ended before the first timed
call (``sanafe_tpu_torch.tracing.setups()``). On the delivery kernel's
path the program holds the blocks' live rows alone (a weight row and its
arrival words each), the list and the block tables; the dense blocks it
held before were 64 KiB a block of 256 float32 rows. None for a program
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
             and s.end_ns <= opened and "delivery.stored_bytes" in s.fields]
    if not built:
        return None
    return built[-1].fields["delivery.stored_bytes"] / 2**20
