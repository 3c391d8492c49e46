"""Spans of the port's host path (sanafe_tpu_torch/tracing.py).

On the CPU, with the chip's and the sweep's programs built in graph form
(``graph=True``: the blocks the card replays, run eagerly), these tests
hold

- one ``sim`` under ``torch.profiler`` to the span tree of ``tracing.py``,
  on a chip on the step scan (the perf trace and detailed timing) and one
  on the DAG engine: names, parents, one call id a call, every child
  inside its parent, and a ``record_function`` event in the profiler's
  timeline for every span;
- the wall fields of ``format_run_summary``'s ``wall_time`` to the sums of
  the spans that feed them, where a profiler records, and the store to no
  new span where none does;
- ``ParameterSweep.run`` to ``sanafe.sweep.run`` -> ``sanafe.chunk`` ->
  ``sanafe.replay`` / ``sanafe.sweep.readback``;
- a sharded sim (one gloo rank) to ``sanafe.exchange`` spans under its
  chunks, which feed ``chip.exchange_wall`` and ``chip.exchanges``;
- a kernel-delivery program's set-up span to ``tracing.setups()``, with
  its delivery counters, and their readers
  (``benchmark/metrics/delivery.stored_mib.py``, ``setup.delivery_s.py``);
- the benchmark's span readers (``benchmark/metrics/replay.host_ms.py``,
  ``chip.wait_ms_per_call.py``, ``chip.trace_ms_per_step.py``) to a
  synthetic store: the window's spans only, None where the store dropped
  some that may lie in the window, None where it holds none.
"""

import collections
import functools
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sanafe_tpu_torch as st
from benchmark.harness.spec import ROOT, load_module
from sanafe_tpu_torch import batch as port_batch
from sanafe_tpu_torch import chip as port_chip
from sanafe_tpu_torch import tracing
from sanafe_tpu_torch.ops import step as port_step
from sanafe_tpu_torch.ops.delivery import CellBlocks
from sanafe_tpu_torch.ops.scan import GRAPH_UNROLL

from test_torch_chips import (
    low_bulk_threshold,  # noqa: F401 (fixture)
    mini_dag_chip,
    random_chip,
)

# each span's parent, by name
PARENT = {
    "sanafe.sim.prepare": "sanafe.sim",
    "sanafe.setup.engine": "sanafe.sim.prepare",
    "sanafe.setup.delivery": "sanafe.setup.engine",
    "sanafe.chunk": "sanafe.sim",
    "sanafe.replay": "sanafe.chunk",
    "sanafe.replay.feeds": "sanafe.replay",
    "sanafe.replay.state": "sanafe.replay",
    "sanafe.replay.launch": "sanafe.replay",
    "sanafe.replay.outputs": "sanafe.replay",
    "sanafe.exchange": "sanafe.chunk",
    "sanafe.book.wait": "sanafe.sim",
    "sanafe.book.decode": "sanafe.sim",
    "sanafe.book.stats": "sanafe.sim",
    "sanafe.book.sweep": "sanafe.sim",
    "sanafe.book.traces": "sanafe.sim",
    "sanafe.sim.finish": "sanafe.sim",
}
# the wall fields of format_run_summary and the spans that feed them
WALLS = {
    "setup_wall": ("sanafe.setup.load", "sanafe.setup.engine"),
    "neuron_processing_wall": ("sanafe.chunk",),
    "message_processing_wall": ("sanafe.book.wait", "sanafe.book.decode"),
    "energy_stats_wall": ("sanafe.book.stats",),
    "scheduler_wall": ("sanafe.book.sweep",),
}
# walls that are a part of one above, and the spans that feed them
PART_WALLS = {"delivery_build_wall": ("sanafe.setup.delivery",)}
# name: (builder, dtype, sim keywords, the replay's children)
ENGINES = {
    "scan": (random_chip, torch.float64,
             dict(timing_model="detailed", perf_trace=True, spike_trace=True),
             ("sanafe.replay.feeds", "sanafe.replay.launch",
              "sanafe.replay.outputs")),
    "dag": (mini_dag_chip, torch.float32,
            dict(timing_model="simple", spike_trace=True),
            ("sanafe.replay.state", "sanafe.replay.launch",
             "sanafe.replay.outputs")),
}
STEPS, CHUNK = 40, 20


@pytest.fixture()
def graph_form(monkeypatch, low_bulk_threshold):  # noqa: F811
    """Make the chip's and the sweep's programs with ``graph=True``; the
    miniature DAG net's convs take the structured path."""
    form = functools.partial(port_step.make_device_program, graph=True)
    monkeypatch.setattr(port_chip, "make_device_program", form)
    monkeypatch.setattr(port_batch, "make_device_program", form)


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def loaded(builder, dtype):
    arch, net = builder(st)
    chip = st.SpikingChip(arch, device="cpu", dtype=dtype)
    return chip, net


def by_name(spans) -> dict:
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def walls(chip) -> dict:
    return {key: getattr(chip, key) for key in (*WALLS, *PART_WALLS)}


def assert_nested(spans) -> dict:
    """Every span's parent is in ``spans`` (but the roots') and holds it;
    returns the spans by id."""
    ids = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns, s.name
        if s.parent is None:
            continue
        parent = ids[s.parent]
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, (
            s.name, parent.name)
        assert s.call == parent.call, s.name
    return ids


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_sim_gives_one_span_tree(graph_form, engine):
    """A first sim under the profiler (the engine built in it): one
    ``sanafe.sim`` root with the chip's call id, each span under the
    parent ``tracing.py`` names and inside it, one chunk a chunk and one
    replay a block, and the profiler's events of the same names."""
    builder, dtype, kwargs, replay_children = ENGINES[engine]
    chip, net = loaded(builder, dtype)
    chip.load(net)
    since = time.perf_counter_ns()
    with profiled() as prof:
        result = chip.sim(STEPS, heartbeat=0, chunk=CHUNK, **kwargs)
    assert result["device_engine"] == engine
    spans = tracing.spans(since)
    ids = assert_nested(spans)
    named = by_name(spans)
    (root,) = named["sanafe.sim"]
    assert root.parent is None and root.call == chip.sim_calls == 1
    assert root.fields == {"steps": STEPS,
                           "timing_model": kwargs["timing_model"]}
    assert {s.call for s in spans} == {1}
    for s in spans:
        if s is not root:
            assert ids[s.parent].name == PARENT[s.name], s.name
    chunks = named["sanafe.chunk"]
    assert [s.fields["steps"] for s in chunks] == [CHUNK] * (STEPS // CHUNK)
    blocks = (-(-CHUNK // GRAPH_UNROLL) if engine == "scan" else 1) * len(
        chunks)
    assert len(named["sanafe.replay"]) == blocks
    assert sum(s.fields["steps"] for s in named["sanafe.replay"]) == STEPS
    assert {s.fields["engine"] for s in named["sanafe.replay"]} == {engine}
    for child in replay_children:
        assert len(named[child]) == blocks, child
    booked = ["sanafe.book.wait", "sanafe.book.decode", "sanafe.book.stats",
              "sanafe.book.traces"]
    if kwargs["timing_model"] == "detailed":
        booked.append("sanafe.book.sweep")
    for name in booked:
        assert len(named[name]) == len(chunks), name
    assert sum(s.fields["spikes"] for s in named["sanafe.book.traces"]) == (
        result["neurons_fired"])
    assert len(named["sanafe.setup.engine"]) == 1
    assert len(named["sanafe.setup.delivery"]) == 1
    assert len(named["sanafe.sim.prepare"]) == 1
    assert len(named["sanafe.sim.finish"]) == 1
    events = collections.Counter(e.name for e in prof.events()
                                 if e.name.startswith("sanafe."))
    assert events == {name: len(found) for name, found in named.items()}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_walls_are_the_sums_of_their_spans(graph_form, engine):
    """With no profiler the store keeps no span and the walls grow; under
    the profiler each wall of ``wall_time`` grows by exactly the sum of
    the spans that feed it, load and the engine's build included, and so
    does ``delivery_build_wall``, a part of ``setup_wall``."""
    builder, dtype, kwargs, _ = ENGINES[engine]
    plain, net = loaded(builder, dtype)
    since = time.perf_counter_ns()
    plain.load(net)
    plain.sim(STEPS, heartbeat=0, chunk=CHUNK, **kwargs)
    assert tracing.spans(since) == []
    assert all(value > 0.0 for key, value in walls(plain).items()
               if key != "scheduler_wall" or engine == "scan")

    chip, net = loaded(builder, dtype)
    before = walls(chip)
    since = time.perf_counter_ns()
    with profiled():
        chip.load(net)
        chip.sim(STEPS, heartbeat=0, chunk=CHUNK, **kwargs)
    named = by_name(tracing.spans(since))
    summary = chip.format_run_summary(port_chip.RunData())
    for key, sources in (*WALLS.items(), *PART_WALLS.items()):
        total = 0.0
        for name in sources:
            for s in named.get(name, []):
                total += (s.end_ns - s.start_ns) * 1e-9
        grown = getattr(chip, key) - before[key]
        assert grown == pytest.approx(total, rel=1e-12, abs=1e-15), key
        if key in WALLS:
            assert f"{getattr(chip, key):f}" in summary


def test_sweep_gives_one_span_tree(graph_form):
    """``ParameterSweep.run``: a ``sanafe.sweep.run`` root with the sweep's
    run number, a chunk a chunk, each with its replays and readback."""
    chip, net = loaded(random_chip, torch.float64)
    chip.load(net)
    thresholds = np.array([0.5, 1.0, 2.0])
    sweep = st.ParameterSweep(chip, {"threshold": st.expand_group_values(
        chip.compiled, "threshold",
        {name: thresholds * 64.0 for name in chip.compiled.groups})})
    sweep.run(STEPS, chunk=CHUNK)
    since = time.perf_counter_ns()
    with profiled():
        sweep.run(STEPS, chunk=CHUNK)
    spans = tracing.spans(since)
    ids = assert_nested(spans)
    named = by_name(spans)
    (root,) = named["sanafe.sweep.run"]
    assert root.parent is None and root.call == sweep.runs == 2
    assert root.fields == {"steps": STEPS, "samples": 3}
    chunks = named["sanafe.chunk"]
    assert len(chunks) == STEPS // CHUNK
    assert all(ids[s.parent] is root for s in chunks)
    for name in ("sanafe.replay", "sanafe.sweep.readback"):
        assert named[name] and all(ids[s.parent].name == "sanafe.chunk"
                                   for s in named[name]), name
    assert len(named["sanafe.replay"]) == len(chunks) * -(
        -CHUNK // GRAPH_UNROLL)
    assert set(named) == {"sanafe.sweep.run", "sanafe.chunk",
                          "sanafe.replay", "sanafe.replay.feeds",
                          "sanafe.replay.launch", "sanafe.replay.outputs",
                          "sanafe.sweep.readback"}


def test_exchange_spans_feed_the_chip(tmp_path):
    """A sharded sim on a one-rank gloo mesh: one ``sanafe.exchange`` span
    a collective, under its chunk, and ``exchange_wall`` / ``exchanges``
    grown by exactly their durations and count."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("cores",))
        chip, net = loaded(random_chip, torch.float64)
        chip.load(net)
        chip.sim(10, timing_model="simple", heartbeat=0, mesh=mesh)
        before = (chip.exchange_wall, chip.exchanges)
        assert before[1] > 0
        since = time.perf_counter_ns()
        with profiled():
            chip.sim(STEPS, timing_model="simple", heartbeat=0, chunk=CHUNK)
    finally:
        dist.destroy_process_group()
    spans = tracing.spans(since)
    ids = assert_nested(spans)
    exchanges = [s for s in spans if s.name == "sanafe.exchange"]
    assert exchanges and all(ids[s.parent].name == "sanafe.chunk"
                             for s in exchanges)
    assert chip.exchanges - before[1] == len(exchanges)
    assert chip.exchange_wall - before[0] == pytest.approx(
        sum((s.end_ns - s.start_ns) * 1e-9 for s in exchanges), rel=1e-12,
        abs=1e-15)


def reader(name: str):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                       "test_reader_" + name.replace(".", "_"))


def synthetic(monkeypatch, spans, drops=(0, 0)):
    """The store holding ``spans`` (name, start ms, end ms), having
    dropped ``drops`` (count, end of the newest in ms)."""
    store = collections.deque(maxlen=tracing.CAPACITY)
    for i, (name, start, end) in enumerate(spans):
        store.append(tracing.Span(i + 1, None, 1, name, int(start * 1e6),
                                  int(end * 1e6), {}))
    monkeypatch.setattr(tracing, "_store", store)
    monkeypatch.setattr(tracing, "_drops", [drops[0], int(drops[1] * 1e6)])


# two calls in the window [100, 160] ms, of 10 steps each
RUN = {"calls": [SimpleNamespace(begin=0.100, end=0.130, steps=10),
                 SimpleNamespace(begin=0.130, end=0.160, steps=10)]}
SPANS = [
    # before the window: a call the profiler's warm-up made
    ("sanafe.replay", 90, 99), ("sanafe.book.wait", 91, 95),
    ("sanafe.book.traces", 95, 99),
    # in it
    ("sanafe.replay", 101, 103), ("sanafe.replay", 131, 135),
    ("sanafe.book.wait", 104, 110), ("sanafe.book.wait", 136, 138),
    ("sanafe.book.traces", 111, 112), ("sanafe.book.traces", 140, 143),
    # after it
    ("sanafe.replay", 170, 190), ("sanafe.book.wait", 171, 172),
    ("sanafe.book.traces", 172, 180),
]


@pytest.mark.parametrize("name, want", [
    ("replay.host_ms", 3.0),  # (2 + 4) / 2
    ("chip.wait_ms_per_call", 4.0),  # (6 + 2) / 2 calls
    ("chip.trace_ms_per_step", 0.2),  # (1 + 3) / 20 steps
])
def test_span_readers_read_the_window(monkeypatch, name, want):
    """Each reader takes the spans that started in the window; a drop
    that may lie in it, or no span in it, gives None."""
    read = reader(name).read
    synthetic(monkeypatch, SPANS)
    assert read(RUN) == pytest.approx(want, rel=1e-9)
    # a drop of a span that ended before the window does not matter
    synthetic(monkeypatch, SPANS[3:], drops=(3, 99))
    assert read(RUN) == pytest.approx(want, rel=1e-9)
    synthetic(monkeypatch, SPANS[4:], drops=(4, 103))
    assert read(RUN) is None
    synthetic(monkeypatch, SPANS[:3] + SPANS[-3:])
    assert read(RUN) is None
    synthetic(monkeypatch, [])
    assert read(RUN) is None


def test_delivery_counters_and_their_readers(monkeypatch):
    """A kernel-delivery program (the CPU runs the same sums) records its
    set-up span ``sanafe.setup.delivery`` with no profiler, kept in
    ``tracing.setups()`` (not in the store) with the counters of its block
    delivery as fields: ``delivery.path`` (the random chip's rows are
    sparse: ``cells``), ``delivery.cells``, ``delivery.live_rows`` (none
    held on that path) and ``delivery.stored_bytes``; the span feeds the
    chip's ``delivery_build_wall``.
    The benchmark's readers read the set-up's spans, those that ended
    before the window's first call, and None where none did or the
    program keeps none."""
    monkeypatch.setattr(port_chip, "make_device_program", functools.partial(
        port_step.make_device_program, use_kernel=True))
    monkeypatch.setattr(tracing, "_setups", collections.deque(
        maxlen=tracing.SETUP_CAPACITY))
    chip, net = loaded(random_chip, torch.float32)
    since = time.perf_counter_ns()
    chip.load(net)
    chip.sim(STEPS, timing_model="simple", heartbeat=0)
    until = time.perf_counter()
    (prog,) = chip._programs.values()
    blk = prog.block
    assert prog.kernel_delivery and chip.delivery_build_wall > 0.0
    assert tracing.spans(since) == []
    named = by_name(tracing.setups())
    assert sorted(named) == ["sanafe.setup.delivery", "sanafe.setup.engine",
                             "sanafe.setup.load"]
    (built,) = named["sanafe.setup.delivery"]
    assert built.fields == {"delivery.path": "cells",
                            "delivery.cells": blk.cells.count,
                            "delivery.live_rows": 0,
                            "delivery.stored_bytes": blk.stored_bytes}
    assert blk.cells.count > 0 and isinstance(blk, CellBlocks)
    assert blk.stored_bytes > blk.cells.weights.numel() * 4
    seconds = (built.end_ns - built.start_ns) * 1e-9
    assert chip.delivery_build_wall == pytest.approx(seconds, rel=1e-12)
    window = {"calls": [SimpleNamespace(begin=until, end=until + 1.0)]}
    assert reader("delivery.stored_mib").read(window) == (
        blk.stored_bytes / 2**20)
    assert reader("setup.delivery_s").read(window) == pytest.approx(
        seconds, rel=1e-12)
    # a set-up after the window's first call is not the cell's
    early = {"calls": [SimpleNamespace(begin=since * 1e-9, end=until)]}
    assert reader("delivery.stored_mib").read(early) is None
    assert reader("setup.delivery_s").read(early) is None
    monkeypatch.delattr(tracing, "setups")
    assert reader("delivery.stored_mib").read(window) is None
    assert reader("setup.delivery_s").read(window) is None
