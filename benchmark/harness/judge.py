"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, as a few numbers, each held to a limit of its
own (``limits/<cell>.json``, set from readings of sound runs and of the
control; ``PERF.md`` gives them)."""

import json

import numpy as np

from .spec import BENCH_DIR

COUNTERS = ("spikes", "packets_sent", "neurons_updated", "neurons_fired")
ENERGIES = ("synapse", "dendrite", "soma", "network", "total")


def relative(got, want) -> float:
    """Largest ``|got - want| / |want|``; a zero ``want`` counts any
    difference as infinite."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    diff = np.abs(got - want)
    scale = np.abs(want)
    if np.isnan(got).any() or np.any((diff > 0) & (scale == 0)):
        return float("inf")
    out = np.divide(diff, scale, out=np.zeros_like(diff), where=diff > 0)
    return float(out.max(initial=0.0))


def readings(result: dict, totals: dict) -> dict:
    """One call's numbers: ``counts`` (counters, relative to the reference,
    at least 1), ``energy`` (each energy, relative) and ``sim_time``
    (relative)."""
    counts = 0.0
    for key in COUNTERS:
        got = np.asarray(result[key], dtype=np.float64).reshape(-1)
        want = np.asarray(totals[key], dtype=np.float64).reshape(-1)
        counts = max(counts, float((np.abs(got - want)
                                    / np.maximum(np.abs(want), 1.0)).max()))
    energy = max(relative(np.reshape(result["energy"][key], -1),
                          np.reshape(totals["energy"][key], -1))
                 for key in ENERGIES)
    sim_time = relative(np.reshape(result["sim_time"], -1),
                        np.reshape(totals["sim_time"], -1))
    return {"counts": counts, "energy": energy, "sim_time": sim_time}


def merge(into: dict, more: dict) -> dict:
    for key, value in more.items():
        into[key] = max(into.get(key, 0.0), value)
    return into


def load_limits(cell: str, bench_dir=BENCH_DIR) -> dict:
    return json.loads((bench_dir / "limits" / f"{cell}.json").read_text())


def verdict(found: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit; a number the
    run could not read, or one with no limit, fails."""
    checks = {}
    ok = True
    for key, limit in limits.items():
        value = found.get(key)
        checks[key] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    for key in found:
        if key not in limits:
            checks[key] = {"value": found[key], "limit": None}
            ok = False
    return ok, checks


def spike_gap(trace, fired, layout) -> float:
    """The spikes in one of the program's trace and the reference's fired
    neurons ``[steps, neurons]`` but not in both, as a share of the
    reference's spikes (at least 1)."""
    if len(trace.data) != len(fired):
        return float("inf")
    differ = 0
    for step, addresses in zip(fired, trace.data):
        got = np.zeros(layout.n, dtype=bool)
        index = [layout.groups[a.group_name][0] + a.neuron_offset
                 for a in addresses]
        got[index] = True
        differ += int(np.count_nonzero(got != step)) + (
            len(index) - len(set(index)))
    return differ / max(int(fired.sum()), 1)
