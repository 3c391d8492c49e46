"""The TCAD'25 random network, "full" size, described from the seed.

128 cores of 256 neurons on the Loihi-like chip. A quarter of the neurons
(exactly), drawn from the seed, are driven by a bias and each sends 4
messages of 8 spikes: 4 distinct destination cores and 8 distinct neurons
in each. The sizes are in ``tcad25_full.json``."""

import numpy as np


def describe(cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cores, per_core = cfg["cores"], cfg["neurons_per_core"]
    messages, spikes = cfg["messages_per_neuron"], cfg["spikes_per_message"]
    n = cores * per_core
    driven = np.sort(rng.choice(
        n, size=round(n * cfg["spike_percentage"] / 100.0), replace=False))
    dest_cores = rng.random((len(driven), cores)).argsort(axis=1)[:, :messages]
    dest_local = rng.random((len(driven), messages, per_core)).argsort(
        axis=2)[:, :, :spikes]
    dst = (dest_cores[:, :, None] * per_core + dest_local).reshape(-1)
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
