"""The share of the traced window's wall time in which the device ran
nothing: 1 - (the union of its kernel and copy spans) / the window. One
reader for every ``device.idle_pct.<part>``: each part moves its own
cells' rate."""


def read(run: dict):
    trace = run["trace"]
    if not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
