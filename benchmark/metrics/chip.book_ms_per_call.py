"""SpikingChip.sim's host booking a call: the change of its
message_processing_wall (waiting for and decoding each chunk's outputs)
and energy_stats_wall (the counters and energies) over the traced window,
per call."""


def read(run: dict):
    walls = run["trace"]["walls"]
    return 1e3 * (walls["message_processing"] + walls["energy_stats"]) / len(
        run["calls"])
