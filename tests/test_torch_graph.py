"""The step scan's graph form (sanafe_tpu_torch/ops/scan.py:ScanGraphs).

On the card a program built with ``graph`` set (``make_device_program``:
the default on CUDA) replays each chunk as CUDA graphs of
``GRAPH_UNROLL`` steps. On the CPU the same program runs the same blocks
eagerly, through the same static buffers and copies: the code the card
captures. These tests build that form on the CPU (``graph=True``) and
hold it

- to the eager scan (``graph=False``, one ``ops/scan.py:steps`` call a
  chunk, as the scan ran before graphs): every trace file byte for byte,
  the result dicts and the states equal;
- to sanafe_tpu under the parity contract of ``tests/test_torch_scan.py``
  and ``tests/test_torch_plugins.py`` (float64): spike and message traces,
  perf.csv and the counters and detailed ``sim_time`` identical, energies
  within 1e-12 relative, potentials identical but on Hodgkin-Huxley
  chips (within 1e-10 * max(1, |v|): torch's and XLA's ``exp`` round
  apart in the last ulp); the stochastic fixture also to the reference
  binary's golden traces, byte for byte.

The chips: ``load_example()`` with the perf trace, the TCAD'25 random chip
forced onto the scan (the perf trace), the stochastic fixture (TrueNorth
LFSR and Poisson feeds, the LIF noise stream), a Hodgkin-Huxley chip (the
shared-unit stride loop), NeuroFEM with and without noise (the noise is
the model's chunk feed; sanafe_tpu draws another stream, so the noisy chip
is held to the eager scan only), and 3-sample ``ParameterSweep``s. Chunks
of 37 and 20 steps are not multiples of ``GRAPH_UNROLL`` and every run
takes several. A checkpoint resumed into a chip whose graphs are cached
is copied into their static state; ``set_attributes`` drops them.

The card test (``-m cuda``, skipped here) holds the captured scan to the
eager scan bit for bit on a 4096-neuron chip in both dtypes, and on the
small chips above; and the DVS net's captured DAG chunk
(``ops/dag_chunk.py:DagGraphs``) to the eager DAG body. The DAG engine's
graph form on the CPU is held in ``tests/test_torch_dag_graph.py``.
sanafe_tpu and JAX are imported inside the tests that use them, so the
card's machine, which has neither, imports this file.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import sanafe_tpu_torch as st
from sanafe_tpu_torch import batch as port_batch
from sanafe_tpu_torch import chip as port_chip
from sanafe_tpu_torch.models import SOMA_MODEL_LIF
from sanafe_tpu_torch.ops import step as port_step
from sanafe_tpu_torch.ops.scan import GRAPH_UNROLL, ScanGraphs, run_scan

from test_torch_chips import (
    dvs_chip,
    example_chip,
    hh_chip,
    neurofem_chip,
    random_chip,
)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden_ref"
FIXTURES = GOLDEN / "fixtures"
F64_REL = 1e-12
COUNTERS = ("spikes", "neurons_fired", "neurons_updated", "packets_sent")
FLAGS = dict(record_fired_axons=True, record_potentials=True,
             record_spikes=True, record_u=True)


def stochastic_chip(mod):
    """``fixtures/arch_stoch.yaml`` + ``snn_stoch.yaml`` (load from the
    fixtures directory: the noise file is cwd-relative)."""
    arch = mod.load_arch(FIXTURES / "arch_stoch.yaml")
    return arch, mod.load_net(FIXTURES / "snn_stoch.yaml", arch)


def noisy_neurofem(mod):
    return neurofem_chip(mod, sigma_v=0.05)


# name: (builder, steps, chunk, timing model, traces, potentials bar
# against sanafe_tpu or None where it draws another noise stream)
CHIPS = {
    "example_perf": (example_chip, 100, 37, "detailed",
                     ("spikes", "potentials", "perf", "messages"), 0.0),
    "random_scan": (random_chip, 60, 20, "detailed",
                    ("spikes", "potentials", "perf"), 0.0),
    "stochastic": (stochastic_chip, 100, 37, "detailed",
                   ("spikes", "potentials", "perf", "messages"), 0.0),
    "hh": (hh_chip, 60, 20, "detailed", ("spikes", "potentials"), 1e-10),
    "neurofem": (neurofem_chip, 60, 37, "detailed",
                 ("spikes", "potentials", "perf"), 0.0),
    "neurofem_noisy": (noisy_neurofem, 60, 37, "detailed",
                       ("spikes", "potentials", "perf"), None),
}


@pytest.fixture()
def graph_form(monkeypatch):
    """Make the chip's and the sweep's programs with ``graph=True``."""
    form = functools.partial(port_step.make_device_program, graph=True)
    monkeypatch.setattr(port_chip, "make_device_program", form)
    monkeypatch.setattr(port_batch, "make_device_program", form)


def run_chip(mod, builder, out: Path, steps: int, chunk: int, timing: str,
             traces: tuple):
    """``steps`` steps of a fresh chip with file traces under ``out``;
    returns the result dict, the trace files' bytes and the chip."""
    arch, net = builder(mod)
    kw = {"device": "cpu", "dtype": torch.float64} if mod is st else {}
    chip = mod.SpikingChip(arch, **kw)
    chip.load(net)
    out.mkdir(parents=True)
    args = {"spikes": "spike_trace", "potentials": "potential_trace",
            "perf": "perf_trace", "messages": "message_trace"}
    result = chip.sim(steps, timing_model=timing, heartbeat=0, chunk=chunk,
                      **{args[t]: out / f"{t}.csv" for t in traces})
    chip.close()
    files = {t: (out / f"{t}.csv").read_bytes() for t in traces}
    return result, files, chip


def plain_result(result: dict) -> dict:
    return {key: value for key, value in result.items()
            if not key.endswith("_trace")}


def potentials(data: bytes) -> np.ndarray:
    rows = data.decode().splitlines()[1:]
    return np.array([[float(x) for x in row.split(",")[1:] if x]
                     for row in rows])


def engines(chip) -> list:
    return [engine for engine in chip._engines.values()
            if engine.name == "scan"]


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_chip_graph_form_matches_eager_and_jax(name, tmp_path, monkeypatch):
    import jax
    import sanafe_tpu as sf

    assert jax.config.jax_enable_x64
    monkeypatch.delenv("SANAFE_PALLAS_CHUNK", raising=False)
    monkeypatch.delenv("SANAFE_TPU_NEUROFEM_SEED", raising=False)
    monkeypatch.chdir(FIXTURES)  # the stochastic chip's noise file
    builder, steps, chunk, timing, traces, v_bar = CHIPS[name]
    args = (steps, chunk, timing, traces)
    eager, eager_files, eager_chip = run_chip(st, builder, tmp_path / "eager",
                                              *args)
    with monkeypatch.context() as patch:
        form = functools.partial(port_step.make_device_program, graph=True)
        patch.setattr(port_chip, "make_device_program", form)
        graph, graph_files, graph_chip = run_chip(
            st, builder, tmp_path / "graph", *args)
    assert graph["device_engine"] == eager["device_engine"] == "scan"
    (engine,) = engines(graph_chip)
    assert engine.prog.graph and isinstance(engine.graphs, ScanGraphs)
    assert not any(e.prog.graph for e in engines(eager_chip))
    assert graph["neurons_fired"] > 0
    assert plain_result(graph) == plain_result(eager)
    assert graph_files == eager_files
    for key, value in eager_chip._device_state.items():
        assert torch.equal(graph_chip._device_state[key], value), key
    if v_bar is None:
        return
    ref, ref_files, _ = run_chip(sf, builder, tmp_path / "jax", *args)
    for key in COUNTERS + ("sim_time",):
        assert graph[key] == ref[key], key
    for key, value in ref["energy"].items():
        assert abs(graph["energy"][key] - value) <= F64_REL * max(
            abs(value), 1e-30), key
    for trace in traces:
        if trace == "potentials" and v_bar:
            a = potentials(ref_files[trace])
            b = potentials(graph_files[trace])
            assert a.shape == b.shape
            assert np.all(np.abs(a - b) <= v_bar * np.maximum(1.0, np.abs(a)))
        else:
            assert graph_files[trace] == ref_files[trace], trace
    if name == "stochastic":
        for trace in traces:
            golden = (GOLDEN / "cfg_stochastic" / f"{trace}.csv").read_bytes()
            assert graph_files[trace] == golden, trace


def test_scan_blocks_equal_eager_scan():
    """``run_scan`` through one ``ScanGraphs`` over chunks of 37, 16 and 5
    steps (remainders and a whole block) equals the eager scan's outputs
    and states bit for bit, and the graphs keep one block a size."""
    arch, net = random_chip(st)
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    chip.load(net)
    eager = port_step.make_device_program(chip.compiled, "cpu",
                                          torch.float64, **FLAGS)
    graph = port_step.make_device_program(chip.compiled, "cpu",
                                          torch.float64, graph=True, **FLAGS)
    assert graph.graph and not eager.graph
    graphs = ScanGraphs(graph, graph.arrays)
    e_state, g_state = eager.init_state(), graph.init_state()
    t = 1
    for length in (37, GRAPH_UNROLL, 5):
        e_state, e_out = run_scan(eager, e_state, t, length)
        g_state, g_out = run_scan(graph, g_state, t, length, graphs=graphs)
        assert sorted(g_out) == sorted(e_out)
        for key, value in e_out.items():
            assert g_out[key].dtype == value.dtype
            assert g_out[key].shape == (length,) + value.shape[1:]
            assert torch.equal(g_out[key].view(torch.uint8),
                               value.view(torch.uint8)), key
        for key, value in e_state.items():
            assert torch.equal(g_state[key], value), key
            assert g_state[key] is not graphs.state[key]
        t += length
    assert int(graphs.t) == t
    assert graphs.replays == 0  # the CPU runs the blocks, replaying none
    with pytest.raises(ValueError, match="layout"):
        graphs.run({"potential": e_state["potential"]}, t, 4, {})


def test_checkpoint_resumed_into_cached_graphs(tmp_path, graph_form):
    """A checkpoint loaded into a chip whose graphs are cached replaces the
    state the next chunk copies into their static state: the resumed run
    repeats the steps after the checkpoint, and equals an eager chip's."""
    def chip_of():
        arch, net = example_chip(st)
        chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
        chip.load(net)
        return chip

    chip = chip_of()
    chip.sim(40, heartbeat=0, perf_trace=True, chunk=20)
    (engine,) = engines(chip)
    graphs = engine.graphs
    path = tmp_path / "mid.npz"
    chip.save_state(path)
    first = chip.sim(30, heartbeat=0, perf_trace=True, chunk=20)
    chip.load_state(path)
    again = chip.sim(30, heartbeat=0, perf_trace=True, chunk=20)
    assert engines(chip)[0].graphs is graphs  # the graphs stayed cached
    for key in COUNTERS + ("sim_time", "energy", "timestep_start"):
        assert again[key] == first[key], key
    assert again["perf_trace"].data == first["perf_trace"].data

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(port_chip, "make_device_program",
                      port_step.make_device_program)
        eager = chip_of()
        eager.sim(40, heartbeat=0, perf_trace=True, chunk=20)
        ref = eager.sim(30, heartbeat=0, perf_trace=True, chunk=20)
    assert not engines(eager)[0].prog.graph
    assert plain_result(ref) == plain_result(again)
    assert ref["perf_trace"].data == again["perf_trace"].data


def test_set_attributes_drops_cached_graphs(graph_form):
    """``set_attributes`` clears the chip's engines, so the next sim()
    builds a program and graphs that read the new threshold; the run
    equals an eager chip given the same update."""
    def run(chip):
        chip.sim(20, heartbeat=0, perf_trace=True)
        (before,) = engines(chip)
        lif = chip.compiled.soma_model == SOMA_MODEL_LIF
        neuron = next(n for group in chip.mapped_neuron_groups.values()
                      for n in group if lif[n._ref.slot])
        neuron.set_attributes({"threshold": 0.25})
        assert not chip._engines
        result = chip.sim(30, heartbeat=0, perf_trace=True)
        (after,) = engines(chip)
        assert after is not before
        assert float(after.prog.arrays["threshold"][neuron._ref.slot]) == 0.25
        return before, after, result

    arch, net = example_chip(st)
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    chip.load(net)
    before, after, result = run(chip)
    assert isinstance(before.graphs, ScanGraphs)
    assert isinstance(after.graphs, ScanGraphs)
    assert after.graphs is not before.graphs
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(port_chip, "make_device_program",
                      port_step.make_device_program)
        arch, net = example_chip(st)
        eager = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
        eager.load(net)
        _, after, ref = run(eager)
    assert after.graphs is None
    assert plain_result(result) == plain_result(ref)
    assert result["perf_trace"].data == ref["perf_trace"].data


def _sweep_chips(builder, **kwargs):
    import sanafe_tpu as sf

    arch, net = builder(sf, **kwargs)
    jchip = sf.SpikingChip(arch)
    jchip.load(net)
    arch, net = builder(st, **kwargs)
    pchip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    pchip.load(net)
    return jchip, pchip


@pytest.mark.parametrize("route", ["fused", "kernel_program", "hh"])
def test_sweep_graph_form_matches_eager_and_jax(route, monkeypatch):
    """A 3-sample sweep, 50 steps in chunks of 20: the graph form equals
    the eager sweep exactly and sanafe_tpu's counters (energies and
    sim_time within 1e-12 relative). ``kernel_program`` builds the
    kernel-delivery program (its plan-checked batched delivery, the plain
    version on the CPU), ``hh`` sweeps the Hodgkin-Huxley chip's
    stimulation currents through the stride loop."""
    from sanafe_tpu.batch import ParameterSweep as JaxSweep
    from sanafe_tpu.batch import expand_group_values as jax_expand

    builder = hh_chip if route == "hh" else random_chip
    jchip, pchip = _sweep_chips(builder)
    if route == "hh":
        overrides = {"plugin_hodgkin_huxley_current": jax_expand(
            jchip.compiled, "plugin_hodgkin_huxley_current",
            {"pop": np.array([-320.0, -250.0, -190.0])},
            base=jchip.compiled.plugin_params["hodgkin_huxley"]["current"])}
    else:
        overrides = {"threshold": jax_expand(
            jchip.compiled, "threshold",
            {"pop": np.array([32.0, 64.0, 200.0])})}
    use_kernel = route == "kernel_program"
    outs = {}
    for graph in (True, False):
        form = functools.partial(port_step.make_device_program, graph=graph,
                                 use_kernel=use_kernel)
        monkeypatch.setattr(port_batch, "make_device_program", form)
        sweep = st.ParameterSweep(pchip, overrides)
        assert sweep.prog.graph == graph
        assert (sweep.graphs is not None) == graph
        assert ("block_batch_plan" in sweep.arrays) == (
            use_kernel and sweep.prog.kernel_delivery)
        outs[graph] = sweep.run(50, chunk=20)
    graph_out, eager_out = outs[True], outs[False]
    for key in COUNTERS + ("sim_time",):
        np.testing.assert_array_equal(graph_out[key], eager_out[key])
    for key in eager_out["energy"]:
        np.testing.assert_array_equal(graph_out["energy"][key],
                                      eager_out["energy"][key])
    ref = JaxSweep(jchip, overrides).run(50)
    for key in COUNTERS:
        np.testing.assert_array_equal(graph_out[key], np.asarray(ref[key]),
                                      err_msg=key)
    assert len(set(graph_out["neurons_fired"].tolist())) > 1
    for key in ref["energy"]:
        np.testing.assert_allclose(graph_out["energy"][key],
                                   ref["energy"][key], rtol=F64_REL, atol=0)
    np.testing.assert_allclose(graph_out["sim_time"], ref["sim_time"],
                               rtol=F64_REL, atol=0)


def test_graph_knob_and_sharded_programs(monkeypatch):
    """``graph=None`` is off on the CPU; ``SANAFE_TPU_GRAPH=0`` keeps a
    program eager; a sharded program refuses graphs."""
    arch, net = example_chip(st)
    chip = st.SpikingChip(arch, device="cpu")
    chip.load(net)
    c = chip.compiled
    assert not port_step.make_device_program(c, "cpu").graph
    assert port_step.make_device_program(c, "cpu", graph=True).graph
    monkeypatch.setenv("SANAFE_TPU_GRAPH", "0")
    assert not port_step.make_device_program(c, "cpu").graph
    with pytest.raises(ValueError, match="sharded"):
        port_step.make_device_program(c, "cpu", graph=True, mesh=object())


# --- on the card --------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    from sanafe_tpu_torch.ops import delivery

    return (delivery.delivery_kernel.launches,
            delivery.delivery_batch_kernel.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_captured_scan_equals_eager_on_cuda(cuda, dtype):
    """The 4096-neuron random chip, every output recorded: chunks of 37
    and 20 steps through one ``ScanGraphs`` (two block sizes captured,
    the rest replayed) give the eager scan's outputs and states bit for
    bit, and the launch counters count one delivery launch a step."""
    arch, net = random_chip(st, cores=32, neurons_per_core=128,
                            n_log_potential=64)
    chip = st.SpikingChip(arch, device=cuda, dtype=dtype)
    chip.load(net)
    c = chip.compiled
    eager = port_step.make_device_program(c, cuda, dtype, graph=False,
                                          **FLAGS)
    graph = port_step.make_device_program(c, cuda, dtype, **FLAGS)
    assert graph.graph and graph.kernel_delivery
    graphs = ScanGraphs(graph, graph.arrays)
    e_state, g_state = eager.init_state(), graph.init_state()
    t = 1
    for length in (37, 20, 37):
        before = _launches()
        e_state, e_out = run_scan(eager, e_state, t, length)
        between = _launches()
        g_state, g_out = run_scan(graph, g_state, t, length, graphs=graphs)
        after = _launches()
        torch.cuda.synchronize()
        assert between[0] - before[0] == length
        assert after[0] - between[0] == length
        for key, value in e_out.items():
            assert torch.equal(g_out[key].view(torch.uint8),
                               value.view(torch.uint8)), (key, t)
        for key, value in e_state.items():
            assert torch.equal(g_state[key].view(torch.uint8),
                               value.view(torch.uint8)), (key, t)
        t += length
    # 37 = 2 x 16 + 5, 20 = 16 + 4: the first block of each size ran
    # eagerly while it was captured, every other block replayed
    assert graphs.replays == 1 + 1 + 3 and set(graphs.blocks) == {16, 5, 4}
    assert e_out["stats"][:, 4].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stochastic", "hh", "neurofem_noisy"])
def test_captured_chips_equal_eager_on_cuda(cuda, name, tmp_path,
                                            monkeypatch):
    """The small chips above on the card, float64: the captured run's
    trace files and result dict equal the eager run's."""
    monkeypatch.chdir(FIXTURES)
    builder, steps, chunk, timing, traces, _ = CHIPS[name]
    runs = []
    for knob in ("1", "0"):
        monkeypatch.setenv("SANAFE_TPU_GRAPH", knob)
        arch, net = builder(st)
        chip = st.SpikingChip(arch, device=cuda, dtype=torch.float64)
        chip.load(net)
        out = tmp_path / knob
        out.mkdir()
        args = {"spikes": "spike_trace", "potentials": "potential_trace",
                "perf": "perf_trace", "messages": "message_trace"}
        result = chip.sim(steps, timing_model=timing, heartbeat=0,
                          chunk=chunk,
                          **{args[t]: out / f"{t}.csv" for t in traces})
        chip.close()
        (engine,) = engines(chip)
        assert engine.prog.graph == (knob == "1")
        runs.append((result, {t: (out / f"{t}.csv").read_bytes()
                              for t in traces}, chip.graph_replays))
    (graph, graph_files, replays), (eager, eager_files, none) = runs
    assert replays > 0 and none == 0
    assert plain_result(graph) == plain_result(eager)
    assert graph_files == eager_files
    if name == "stochastic":
        for trace in traces:
            golden = (GOLDEN / "cfg_stochastic" / f"{trace}.csv").read_bytes()
            assert graph_files[trace] == golden, trace


@pytest.mark.cuda
def test_captured_sweep_equals_eager_on_cuda(cuda, monkeypatch):
    """A 3-sample threshold sweep of the 4096-neuron chip on the card
    (the batched delivery kernel inside the graph): the captured sweep's
    aggregates equal the eager sweep's exactly, and the batched kernel is
    counted once a step."""
    arch, net = random_chip(st, cores=32, neurons_per_core=128,
                            n_log_potential=0)
    chip = st.SpikingChip(arch, device=cuda)
    chip.load(net)
    values = chip.compiled.threshold[0] * np.array([0.5, 1.0, 2.0])
    overrides = {"threshold": st.expand_group_values(
        chip.compiled, "threshold", {"pop": values})}
    outs = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("SANAFE_TPU_GRAPH", knob)
        sweep = st.ParameterSweep(chip, overrides)
        before = _launches()[1]
        outs[knob] = sweep.run(50, chunk=20)
        assert _launches()[1] - before == 50
    for key in COUNTERS + ("sim_time",):
        np.testing.assert_array_equal(outs["1"][key], outs["0"][key])
    for key in outs["0"]["energy"]:
        np.testing.assert_array_equal(outs["1"]["energy"][key],
                                      outs["0"]["energy"][key])


@pytest.mark.cuda
def test_captured_dvs_chunk_equals_eager_on_cuda(cuda):
    """The DVS net's DAG chunk on the card, every output recorded: chunks
    of 200, 73, 200 and 73 steps through one ``DagGraphs`` (each length
    captured at its first chunk, replayed after) give the eager body's
    masks, stats, spike log, potential and u logs and state bit for bit,
    with the level kernel counted six launches a chunk in both modes; the
    first chunk's outputs are unchanged after the later chunks."""
    from sanafe_tpu_torch.ops import level_scan
    from sanafe_tpu_torch.ops.dag_chunk import (
        DagGraphs,
        make_dag_body,
        plan_dag,
        run_dag,
    )

    arch, net = dvs_chip(st)
    chip = st.SpikingChip(arch, device=cuda)
    chip.load(net)
    prog = port_step.make_device_program(chip.compiled, cuda, torch.float32,
                                          **FLAGS)
    assert prog.graph
    body = make_dag_body(prog, plan_dag(prog))
    graphs = DagGraphs(prog, body)
    e_state = g_state = prog.init_state()
    t, first = 1, None
    for length in (200, 73, 200, 73):
        before = level_scan.level_kernel.launches
        e_state, e_out = run_dag(body, prog, e_state, t, length)
        between = level_scan.level_kernel.launches
        g_state, g_out = run_dag(body, prog, g_state, t, length,
                                 graphs=graphs)
        after = level_scan.level_kernel.launches
        torch.cuda.synchronize()
        assert between - before == after - between == 6
        assert sorted(g_out) == sorted(e_out)
        for key, value in e_out.items():
            assert torch.equal(g_out[key].view(torch.uint8),
                               value.view(torch.uint8)), (key, t)
        for key, value in e_state.items():
            assert torch.equal(g_state[key].view(torch.uint8),
                               value.view(torch.uint8)), (key, t)
        if first is None:
            first = (g_out, {k: v.clone() for k, v in g_out.items()})
        t += length
    assert graphs.replays == 2 and set(graphs.chunks) == {200, 73}
    for key, value in first[1].items():
        assert torch.equal(first[0][key].view(torch.uint8),
                           value.view(torch.uint8)), key
    assert e_out["stats"][:, 4].sum() > 0
