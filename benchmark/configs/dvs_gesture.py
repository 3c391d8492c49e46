"""DVS-gesture by SANA-FE's tutorial 5 recipe, described as plain arrays.

A 32x32 input layer driven by the packaged frame's biases, four 3x3
convolutions (the first of stride 2) and an 11-neuron dense head, with the
packaged trained weights and thresholds, each layer spread evenly over its
cores of the Loihi-like chip. Every seed runs the packaged frame (the net
and its input are frozen data). The sizes are in ``dvs_gesture.json``."""

from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent.parent / "data"


def _spread(n: int, count: int, first_core: int) -> np.ndarray:
    """Each of ``count`` cores takes ``n // count`` neurons in order, the
    last the rest (the tutorial's mapping)."""
    per_core = n // count
    return first_core + np.minimum(np.arange(n) // per_core, count - 1)


def describe(cfg: dict, seed: int) -> dict:
    del seed  # the same frame for every seed
    with np.load(DATA / cfg["data"]) as data:
        arrays = {key: data[key] for key in data.files}
    width, height = cfg["input_width"], cfg["input_height"]
    frame = arrays["inputs"].reshape(height, width)
    thresholds = arrays["thresholds"].astype(np.float64)
    shapes = [(cfg["input_channels"], height, width)]
    edges = []
    names = ["input_0"]
    for k, (key, stride) in enumerate(zip(cfg["conv_layers"],
                                          cfg["conv_strides"])):
        kernel = arrays[key].astype(np.float64)  # (kh, kw, c_in, c_out)
        c_in, h, w = shapes[-1]
        k_h, k_w, _, c_out = kernel.shape
        shapes.append((c_out, (h - k_h) // stride + 1,
                       (w - k_w) // stride + 1))
        names.append(f"conv2d_{k}")
        edges.append({
            "kind": "conv2d", "src": names[-2], "dst": names[-1],
            "in_w": w, "in_h": h, "in_c": c_in, "k_w": k_w, "k_h": k_h,
            "out_c": c_out, "s_w": stride, "s_h": stride, "weight": kernel,
        })
    for k, key in enumerate(cfg["dense_layers"]):
        matrix = arrays[key].astype(np.float64)  # (n_src, n_dst)
        shapes.append((matrix.shape[1], 1, 1))
        names.append(f"dense_{k}")
        edges.append({"kind": "dense", "src": names[-2], "dst": names[-1],
                      "weight": matrix})
    groups, first_core = [], 0
    for name, shape, threshold, count in zip(names, shapes, thresholds,
                                             cfg["layer_cores"]):
        n = int(np.prod(shape))
        groups.append({"name": name, "n": n,
                       "attributes": {"threshold": float(threshold)},
                       "cores": _spread(n, count, first_core)})
        first_core += count
    return {
        "name": cfg["name"],
        "arch": cfg["arch"],
        "dtype": cfg["dtype"],
        "groups": groups,
        "neuron_attributes": [{
            "group": "input_0", "key": "bias",
            "index": np.arange(width * height),
            "value": frame.reshape(-1).astype(np.float64),
        }],
        "edges": edges,
    }
