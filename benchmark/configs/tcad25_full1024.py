"""The TCAD'25 random network at the last "full" row of its script, the
largest it runs, described from the seed.

128 cores of 1,024 neurons on the Loihi-like chip: every core of the chip
full. Half of the neurons (exactly), drawn from the seed, are driven by a
bias and each sends 16 messages of 16 spikes: 16 distinct destination
cores and 16 distinct neurons in each, 16,777,216 edges. The sizes are in
``tcad25_full1024.json``.

The draws hold memory of the edges' size: a driven neuron's cores rank a
random key a core; a message's neurons are 16 uniform draws from its core,
and the messages whose draw repeats a neuron draw again until none does
(a uniform draw of a 16-set, each in a uniform order)."""

import numpy as np

# messages drawn at a time: their draws and sorted copies, a few MB each
BLOCK = 1 << 16


def distinct_draws(rng, rows: int, k: int, n: int) -> np.ndarray:
    """``[rows, k]`` int64: each row ``k`` distinct values of ``range(n)``,
    uniform and in a uniform order, drawn ``BLOCK`` rows at a time."""
    out = np.empty((rows, k), dtype=np.int64)
    for lo in range(0, rows, BLOCK):
        part = out[lo:lo + BLOCK]
        redo = np.arange(len(part))
        while len(redo):
            part[redo] = rng.integers(0, n, size=(len(redo), k))
            ordered = np.sort(part[redo], axis=1)
            redo = redo[(ordered[:, 1:] == ordered[:, :-1]).any(axis=1)]
    return out


def describe(cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cores, per_core = cfg["cores"], cfg["neurons_per_core"]
    messages, spikes = cfg["messages_per_neuron"], cfg["spikes_per_message"]
    n = cores * per_core
    driven = np.sort(rng.choice(
        n, size=round(n * cfg["spike_percentage"] / 100.0), replace=False))
    dest_cores = rng.random((len(driven), cores)).argsort(axis=1)[
        :, :messages]
    dest_local = distinct_draws(rng, len(driven) * messages, spikes,
                                per_core)
    dst = (dest_cores.reshape(-1, 1) * per_core + dest_local).reshape(-1)
    src = np.repeat(driven, messages * spikes)
    return {
        "name": cfg["name"],
        "arch": cfg["arch"],
        "dtype": cfg["dtype"],
        "groups": [{
            "name": "pop",
            "n": n,
            "attributes": {"threshold": cfg["threshold"],
                           "reset": cfg["reset"],
                           "force_update": cfg["force_update"]},
            "cores": np.arange(n) // per_core,
        }],
        "neuron_attributes": [{
            "group": "pop", "key": "bias", "index": driven,
            "value": np.full(len(driven), cfg["bias"]),
        }],
        "edges": [{
            "kind": "sparse", "src": "pop", "dst": "pop",
            "src_idx": src, "dst_idx": dst,
            "weight": np.full(len(src), cfg["weight"]),
        }],
    }
