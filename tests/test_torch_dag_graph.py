"""The DAG engine's graph form (sanafe_tpu_torch/ops/dag_chunk.py:DagGraphs).

On the card a program built with ``graph`` set (``make_device_program``:
the default on CUDA) replays each DAG chunk as one CUDA graph of its
length. On the CPU the same ``DagGraphs`` runs the chunk eagerly, through
the same static state, step tensor and copies: the code the card
captures. These tests hold that form, on the miniature DAG net
(``tests/test_torch_chips.py:mini_dag_chip``, three levels, 1,298
neurons) over chunks of two lengths,

- to the eager DAG body bit for bit, outputs and state;
- to sanafe_tpu's jitted ``make_dag_body`` under the DVS tests' rule
  (``tests/test_torch_dvs.py:_assert_outputs_equal``: equal, the stats'
  float columns within 1e-6 of the float64 roll-up or no farther than
  sanafe_tpu's);

and check that a chunk's outputs are the caller's own, that
``level_plain`` takes its start step as a 0-d tensor, that
``set_attributes`` drops the DAG graphs, and that ``SANAFE_TPU_GRAPH=0``
builds none. The card test is ``tests/test_torch_graph.py::
test_captured_dvs_chunk_equals_eager_on_cuda``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import sanafe_tpu_torch as st
from sanafe_tpu_torch import chip as port_chip
from sanafe_tpu_torch.ops import step as port_step
from sanafe_tpu_torch.ops.dag_chunk import (
    DagGraphs,
    make_dag_body,
    plan_dag,
    run_dag,
)
from sanafe_tpu_torch.ops.level_scan import PARAM_KEYS, level_plain

from test_torch_chips import (
    low_bulk_threshold,  # noqa: F401 (fixture)
    mini_dag_chip,
)
from test_torch_dvs import FLAGS, _as_np, _assert_outputs_equal, _compiled
from test_torch_dvs import f32  # noqa: F401 (fixture)

LENGTHS = (24, 13, 24)  # three chunks of two lengths


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bit pattern (so that -0.0 and 0.0 differ)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    return x


def _assert_same(a: dict, b: dict, what: str) -> None:
    assert sorted(a) == sorted(b), what
    for key, value in a.items():
        assert b[key].dtype == value.dtype, (what, key)
        assert torch.equal(_bits(b[key]), _bits(value)), (what, key)


@pytest.mark.parametrize("inputs", [False, True])
def test_dag_graphs_equal_eager_body_and_jax(f32, low_bulk_threshold,
                                             inputs):
    """``run_dag`` through one ``DagGraphs`` over chunks of 24, 13 and 24
    steps equals the eager body bit for bit (state included) and
    sanafe_tpu's jitted DAG body; the first chunk's outputs are unchanged
    after the later chunks; a state of another layout raises."""
    from sanafe_tpu.ops.dag_chunk import make_dag_body as jax_dag_body
    from sanafe_tpu.ops.dag_chunk import plan_dag as jax_plan_dag
    from sanafe_tpu.ops.step import make_device_program as jax_program

    jc, pc = _compiled(lambda mod: mini_dag_chip(mod, inputs))
    jprog = jax_program(jc, **FLAGS)
    pprog = port_step.make_device_program(pc, "cpu", torch.float32,
                                          graph=True, **FLAGS)
    body = make_dag_body(pprog, plan_dag(pprog))
    graphs = DagGraphs(pprog, body)
    e_state = g_state = pprog.init_state()
    jstate = jprog.init_state()
    jplan = jax_plan_dag(jprog)
    t0, fired, first = 1, 0, None
    for length in LENGTHS:
        e_state, e_out = run_dag(body, pprog, e_state, t0, length)
        g_state, g_out = run_dag(body, pprog, g_state, t0, length,
                                 graphs=graphs)
        _assert_same(e_out, g_out, f"outputs from {t0}")
        _assert_same(e_state, g_state, f"state from {t0}")
        for key, value in g_state.items():
            assert value is not graphs.state[key]
        if first is None:
            first = (g_out, {k: v.clone() for k, v in g_out.items()})
        jbody = jax.jit(jax_dag_body(jprog, jplan, length))
        ts = jax.numpy.arange(t0, t0 + length)
        jstate, jout = jbody(jprog.arrays, jstate, ts, {})
        _assert_outputs_equal(_as_np(jout), _as_np(g_out), f"chunk {t0}",
                              pprog)
        _assert_outputs_equal(_as_np(jstate), _as_np(g_state),
                              f"state {t0}")
        fired += int(g_out["stats"][:, 4].sum())
        t0 += length
    assert fired > 0
    _assert_same(first[1], first[0], "the first chunk's kept outputs")
    assert int(graphs.t) == t0 - LENGTHS[-1]
    # the CPU runs the chunks, capturing and replaying none
    assert graphs.replays == 0 and not graphs.chunks
    with pytest.raises(ValueError, match="layout"):
        graphs.run({"potential": e_state["potential"]}, t0, 4)


@pytest.mark.parametrize("t0", [1, 40])
def test_level_plain_takes_a_step_tensor(t0):
    """``level_plain`` with ``t0`` as a 0-d int64 tensor (as the DAG body
    gives it) equals the same call with an int, bit for bit, from step 1
    (no leak on the first step) and from step 40."""
    size, steps = 97, 21
    rng = np.random.default_rng(t0)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    params = {
        "bias": f(size) * 0.1,
        "leak_decay": torch.from_numpy(rng.random(size).astype(np.float32)),
        "input_decay": torch.from_numpy(rng.random(size).astype(np.float32)),
        "threshold": f(size).abs() + 0.5,
        "reverse_threshold": -f(size).abs() - 0.5,
        "reset": f(size) * 0.1,
        "reverse_reset": -f(size).abs() * 0.1,
        "refractory_delay": torch.from_numpy(
            rng.integers(0, 4, size).astype(np.int32)),
        "reset_mode": torch.arange(size, dtype=torch.int32) % 3,
        "reverse_reset_mode": torch.arange(size, dtype=torch.int32) // 3 % 4,
        "force_update": torch.from_numpy(rng.random(size) < 0.3),
    }
    assert sorted(params) == sorted(PARAM_KEYS)
    args = (params, f(size), f(size) * 0.1,
            torch.from_numpy(rng.integers(0, 3, size).astype(np.int32)),
            f(steps, size), torch.from_numpy(rng.random((steps, size)) < 0.4),
            f(steps, size) * 0.05)
    want = level_plain(*args, t0, True, True)
    got = level_plain(*args, torch.tensor(t0, dtype=torch.int64), True, True)
    for field in want._fields:
        assert torch.equal(_bits(getattr(got, field)),
                           _bits(getattr(want, field))), field
    assert bool(want.fired.any())


def _dag_engine(chip):
    (engine,) = [e for e in chip._engines.values() if e.name == "dag"]
    return engine


def test_set_attributes_drops_dag_graphs(low_bulk_threshold, monkeypatch):
    """A chip whose programs replay graphs (``graph=True``; the CPU runs
    them in graph form) builds ``DagGraphs`` for its DAG engine;
    ``set_attributes`` clears the engine, and the next sim() builds a body
    and graphs that read the new thresholds. The result equals an eager
    chip's given the same update (built under ``SANAFE_TPU_GRAPH=0``,
    which builds no DAG graphs) and differs from a run without it."""
    def run(update: bool):
        arch, net = mini_dag_chip(st)
        chip = st.SpikingChip(arch, device="cpu")
        chip.load(net)
        chip.sim(20, heartbeat=0)
        before = _dag_engine(chip)
        if update:
            for neuron in chip.mapped_neuron_groups["in"][:64]:
                neuron.set_attributes({"threshold": 4.0})
            assert not chip._engines
        result = chip.sim(30, heartbeat=0)
        after = _dag_engine(chip)
        assert (after is not before) == update
        assert result["device_engine"] == "dag"
        slot = chip.mapped_neuron_groups["in"][0]._ref.slot
        assert float(after.prog.arrays["threshold"][slot]) == (
            4.0 if update else 1.0)
        return before, after, result

    with monkeypatch.context() as patch:
        patch.setattr(port_chip, "make_device_program", functools.partial(
            port_step.make_device_program, graph=True))
        before, after, result = run(True)
        _, _, unchanged = run(False)
    assert isinstance(before.graphs, DagGraphs)
    assert isinstance(after.graphs, DagGraphs)
    assert after.graphs is not before.graphs
    assert after.graphs.body is after.dag
    monkeypatch.setenv("SANAFE_TPU_GRAPH", "0")
    eager_before, eager_after, ref = run(True)
    assert eager_before.graphs is None and eager_after.graphs is None
    assert not eager_after.prog.graph
    assert {k: v for k, v in result.items() if not k.endswith("_trace")} == {
        k: v for k, v in ref.items() if not k.endswith("_trace")}
    assert result["neurons_fired"] != unchanged["neurons_fired"]
