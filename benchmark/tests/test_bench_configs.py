"""The configurations' descriptions: deterministic in the seed, and the
sizes their sources state."""

import numpy as np
import pytest

from benchmark.harness import spec


def describe(name: str, seed: int, **cut):
    bench = spec.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}[name]
    import json

    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    cfg.update(cut)
    module = spec.load_module(spec.BENCH_DIR / "configs" / f"{name}.py",
                              f"test_config_{name}")
    return module.describe(cfg, seed)


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name,cut", [
    ("tcad25_full", {"cores": 8, "neurons_per_core": 64}),
    ("dvs_gesture", {}),
])
def test_description_is_deterministic_in_the_seed(name, cut):
    big = 2**31 + 12345
    assert same(describe(name, big, **cut), describe(name, big, **cut))


def test_tcad25_full_seeds_draw_other_networks_of_one_size():
    a = describe("tcad25_full", 1, cores=8, neurons_per_core=64)
    b = describe("tcad25_full", 2, cores=8, neurons_per_core=64)
    assert not same(a["edges"], b["edges"])
    for d in (a, b):
        e = d["edges"][0]
        driven = d["neuron_attributes"][0]["index"]
        assert len(driven) == 8 * 64 // 4  # exactly a quarter, every seed
        assert len(e["src_idx"]) == len(driven) * 4 * 8
        # 4 distinct destination cores a source, 8 distinct neurons in each
        per_src = e["dst_idx"].reshape(len(driven), 4, 8)
        assert all(len(set(row.ravel().tolist())) == 32 for row in per_src)
        cores = per_src // 64
        assert (cores == cores[:, :, :1]).all()
        assert all(len(set(row.tolist())) == 4 for row in cores[:, :, 0])


def test_tcad25_full_at_its_published_size():
    d = describe("tcad25_full", 7)
    assert d["groups"][0]["n"] == 128 * 256
    assert d["groups"][0]["cores"].max() == 127


def test_dvs_gesture_at_its_published_size_and_one_input_for_every_seed():
    a, b = describe("dvs_gesture", 0), describe("dvs_gesture", 99)
    assert same(a, b)
    assert sum(g["n"] for g in a["groups"]) == 18678
    assert [len(set(g["cores"].tolist())) for g in a["groups"]] == \
        [1, 4, 16, 16, 4, 1]
    from benchmark.reference.chip import Layout

    assert Layout(a).n_edges == 3564441
