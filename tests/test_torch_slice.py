"""The port's simulation slice end to end: sanafe_tpu_torch.SpikingChip on
the CPU (the plain version of the chunk kernel) against sanafe_tpu.

- float32 lane: against sanafe_tpu with the Pallas chunk kernel in
  interpret mode (SANAFE_PALLAS_CHUNK=interpret, x64 off), as
  tests/test_pallas_chunk.py runs it: counters exact, energies and sim_time
  within 1e-6 relative (both sum the chunk on the device in Kahan float32,
  with the matvec rows added in different orders), spikes.csv byte-identical.
- float64 lane: against the JAX x64 step scan (conftest.py turns x64 on):
  masks and counters identical, spikes.csv byte-identical, energies and the
  simple-timing sim_time within 1e-12 relative (per-step sums are added in
  another order).
- State carried from a sanafe_tpu checkpoint into the port.
- The port imports and runs with jax, sanafe_tpu and yaml unavailable.
- Chips the whole-chunk engine refuses and the perf trace run on the step
  scan (tests/test_torch_scan.py holds the scan to sanafe_tpu's).
- Requests the port refuses: a mesh that is not a DeviceMesh, a native
  plugin library.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sanafe_tpu as sf
import sanafe_tpu_torch as st
from sanafe_tpu_torch.ops import chunk as port_chunk

from test_torch_chips import CHIPS, compile_both, example_chip, random_chip

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def f32(monkeypatch):
    """sanafe_tpu's float32 lane: x64 off, the Pallas chunk kernel in
    interpret mode."""
    monkeypatch.setenv("SANAFE_PALLAS_CHUNK", "interpret")
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture()
def f64(monkeypatch):
    """sanafe_tpu's float64 lane: x64 on (conftest.py), the step scan."""
    monkeypatch.delenv("SANAFE_PALLAS_CHUNK", raising=False)
    assert jax.config.jax_enable_x64


def loaded(mod, builder, **kw):
    arch, net = builder(mod)
    chip = mod.SpikingChip(arch, **kw)
    chip.load(net)
    return chip


def assert_match(a, b, rel):
    for k in ("spikes", "neurons_fired", "neurons_updated", "packets_sent"):
        assert a[k] == b[k], k
    for k in ("synapse", "dendrite", "soma", "network", "total"):
        ref = a["energy"][k]
        assert abs(ref - b["energy"][k]) <= rel * max(abs(ref), 1e-30), k
    ref = a["sim_time"]
    assert abs(ref - b["sim_time"]) <= rel * max(abs(ref), 1e-30)


def sim_both(builder, tmp_path, dtype, timing_model, steps=200, chunk=100):
    """The same chip through both packages, spikes.csv to ``tmp_path``."""
    runs = []
    for mod, kw in ((sf, {}), (st, {"device": "cpu", "dtype": dtype})):
        chip = loaded(mod, builder, **kw)
        runs.append(chip.sim(
            steps, timing_model=timing_model, heartbeat=0, chunk=chunk,
            spike_trace=tmp_path / f"{mod.__name__}_spikes.csv",
            potential_trace=True,
        ))
        chip.close()  # flush spikes.csv
    spikes = [(tmp_path / f"{mod.__name__}_spikes.csv").read_bytes()
              for mod in (sf, st)]
    return runs, spikes


@pytest.mark.parametrize("timing_model", ["detailed", "simple"])
@pytest.mark.parametrize("name", ["example", "random"])
def test_float32_lane_matches_pallas_interpret(f32, tmp_path, name,
                                               timing_model):
    (a, b), (spikes_a, spikes_b) = sim_both(
        CHIPS[name], tmp_path, torch.float32, timing_model
    )
    assert a["device_engine"] == "pallas_chunk"
    assert b["device_engine"] == "chunk_plain"
    assert a["spikes"] > 0
    assert_match(a, b, 1e-6)
    assert spikes_a == spikes_b
    pa = np.asarray(a["potential_trace"].data)
    pb = np.asarray(b["potential_trace"].data)
    assert pa.shape == pb.shape
    assert np.all(np.abs(pa - pb) <= 1e-6 * np.maximum(1.0, np.abs(pa)))


def example_chip_logging_u(mod):
    arch, net = example_chip(mod)
    for neuron in net.groups["hidden"]:
        neuron.set_attributes(model_attributes={"log_u": True})
    return arch, net


@pytest.mark.parametrize("timing_model", ["detailed", "cycle"])
def test_float32_lane_message_and_neuron_traces(f32, tmp_path, timing_model):
    """The host half the port copies: message.csv (stream) and the
    in-memory message and u traces, under detailed and cycle timing."""
    runs = []
    for mod, kw in ((sf, {}), (st, {"device": "cpu"})):
        chip = loaded(mod, example_chip_logging_u, **kw)
        runs.append(chip.sim(
            40, timing_model=timing_model, heartbeat=0, chunk=20,
            message_trace=tmp_path / f"{mod.__name__}_messages.csv",
            neuron_trace=True,
        ))
        chip.close()
        mem = loaded(mod, example_chip_logging_u, **kw).sim(
            40, timing_model=timing_model, heartbeat=0, chunk=20,
            message_trace=True,
        )
        runs[-1]["message_memory"] = mem["message_trace"].data
    a, b = runs
    assert_match(a, b, 1e-6)
    assert a["sim_time"] == b["sim_time"]  # same host sweep, same masks
    assert a["packets_sent"] > 0
    messages = [(tmp_path / f"{mod.__name__}_messages.csv").read_bytes()
                for mod in (sf, st)]
    assert messages[0] == messages[1]
    assert a["message_memory"] == b["message_memory"]
    ua = np.asarray(a["neuron_trace"].data["u"])
    ub = np.asarray(b["neuron_trace"].data["u"])
    assert ua.shape == ub.shape == (40, 4)
    assert np.all(np.abs(ua - ub) <= 1e-6 * np.maximum(1.0, np.abs(ua)))


@pytest.mark.parametrize("timing_model", ["detailed", "simple"])
def test_float64_lane_matches_jax_scan(f64, tmp_path, timing_model):
    (a, b), (spikes_a, spikes_b) = sim_both(
        random_chip, tmp_path, torch.float64, timing_model
    )
    assert a["device_engine"] == "scan"
    assert b["device_engine"] == "chunk_plain"
    assert a["spikes"] > 0
    assert_match(a, b, 1e-12)
    if timing_model == "detailed":
        # the host sweep over the same masks gives the same float64 sum
        assert a["sim_time"] == b["sim_time"]
    assert spikes_a == spikes_b
    assert a["potential_trace"].data == b["potential_trace"].data


def test_float64_masks_match_jax_scan(f64):
    """Per-step fired/updated masks, spike-log bytes and potential logs of
    one chunk: the port's float64 plain version against the JAX x64 scan."""
    from sanafe_tpu.ops.step import make_device_program as jax_program
    from sanafe_tpu_torch.ops.step import make_device_program as port_program

    flags = dict(record_fired_axons=True, record_potentials=True,
                 record_spikes=True)
    steps = 100
    jax_compiled, port_compiled = compile_both("random")
    jprog = jax_program(jax_compiled, **flags)
    state0 = jprog.init_state()
    _, out = jprog.make_scan(steps)(state0, np.int64(1))
    pprog = port_program(port_compiled, "cpu", torch.float64, **flags)
    plan = port_chunk.plan_chunk(pprog)
    rows = port_chunk.state_rows(
        plan, {k: torch.tensor(np.asarray(v)) for k, v in state0.items()},
        torch.float64,
    )
    _, packed = port_chunk.chunk_kernel(
        plan, port_chunk.chunk_tensors(plan, "cpu"), rows, 1, steps,
        *port_chunk.build_planes(pprog, plan, steps, 1, {}),
    )
    dec = port_chunk.decode_packed(
        packed.numpy(), port_chunk.packed_layout(plan, steps, torch.float64)
    )
    masks = np.asarray(out["masks_packed"])
    np.testing.assert_array_equal(masks, dec["masks_packed"])
    # the scan leaves the spike log out when the fired masks carry it
    fired = np.unpackbits(masks[:, 0, :], axis=1)
    np.testing.assert_array_equal(
        np.packbits(fired[:, jax_compiled.spike_log_slots], axis=1),
        dec["spike_log_packed"],
    )
    np.testing.assert_array_equal(np.asarray(out["potential_log"]),
                                  dec["potential_log"])
    stats = np.asarray(out["stats"], dtype=np.float64)
    np.testing.assert_array_equal(
        np.round(stats[:, :5]).astype(np.int64).sum(axis=0),
        dec["counter_sums"],
    )
    np.testing.assert_allclose(dec["energy_sums"], stats[:, 5:9].sum(axis=0),
                               rtol=1e-12)
    np.testing.assert_allclose(dec["sim_time_sum"], stats[:, 10].sum(),
                               rtol=1e-12)


def test_state_carried_from_jax_checkpoint(f32, tmp_path):
    """Run sanafe_tpu 8 steps, carry its .npz checkpoint into the port,
    then run both 50 more steps: the same results as if one chip ran on
    (the example's input trains run to step 16, so inputs, potentials and
    the timestep counter all carry over)."""
    jchip = loaded(sf, example_chip)
    jchip.sim(8, heartbeat=0, chunk=8)
    ckpt = tmp_path / "state.npz"
    jchip.save_state(ckpt)
    pchip = loaded(st, example_chip, device="cpu")
    with np.load(ckpt) as data:
        pchip.load_state_arrays(dict(data))
    assert pchip.total_timesteps == 8
    a = jchip.sim(50, heartbeat=0, chunk=50, spike_trace=True,
                  potential_trace=True)
    b = pchip.sim(50, heartbeat=0, chunk=50, spike_trace=True,
                  potential_trace=True)
    assert a["timestep_start"] == b["timestep_start"] == 9
    assert a["spikes"] > 0
    assert_match(a, b, 1e-6)
    as_pairs = [
        [[(n.group_name, n.neuron_offset) for n in step]
         for step in r["spike_trace"].data]
        for r in (a, b)
    ]
    assert as_pairs[0] == as_pairs[1]
    pa = np.asarray(a["potential_trace"].data)
    pb = np.asarray(b["potential_trace"].data)
    assert np.all(np.abs(pa - pb) <= 1e-6 * np.maximum(1.0, np.abs(pa)))


def test_port_runs_without_jax():
    """sanafe_tpu_torch imports and simulates, on both engines, with jax,
    sanafe_tpu and yaml blocked, and loads none of them (the CLI, the
    plugin loader and the plugin models included)."""
    code = """
import sys
for name in ("jax", "jaxlib", "sanafe_tpu", "yaml"):
    sys.modules[name] = None
import torch
import sanafe_tpu_torch as st
from sanafe_tpu_torch.ops import (cuda_build, delivery, device_sweep,
                                  exact_energy, merge_sweep, scan)
from sanafe_tpu_torch import cli, netlist, plugins, yaml_arch, yaml_io, yaml_snn
from sanafe_tpu_torch.models import hodgkin_huxley, neurofem
from sanafe_tpu_torch.utils import ranges
arch, net = st.load_example()
chip = st.SpikingChip(arch, device="cpu")
chip.load(net)
result = chip.sim(20, heartbeat=0)
assert result["device_engine"] == "chunk_plain", result["device_engine"]
assert result["timesteps_executed"] == 20
chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
chip.load(net)
perf = chip.sim(20, heartbeat=0, perf_trace=True)
assert perf["device_engine"] == "scan", perf["device_engine"]
assert perf["spikes"] == result["spikes"]
assert len(perf["perf_trace"]["fired"]) == 20
swept = chip.sim(20, heartbeat=0, device_sweep=True)
assert swept["device_engine"] == "scan" and swept["sim_time"] > 0
loaded = [m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "yaml") or m.startswith("sanafe_tpu.")
)]
assert not loaded, loaded
print("spikes", result["spikes"])
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("spikes ")
    assert int(proc.stdout.split()[1]) > 0


@pytest.mark.parametrize("name", ["scheduler.cpp", "cycle_noc.h"])
def test_native_source_copy_matches_sanafe_tpu(name):
    """The port compiles its own copy of the native scheduler source. The
    copy of scheduler.cpp differs from sanafe_tpu's by one added
    ``#include <cstdio>`` line and the port's own ``spike_rows`` (one block
    between its marker lines), and cycle_noc.h is identical (exact), so a
    change to sanafe_tpu's source shows here and not as silent drift; and
    native.py reads no path under sanafe_tpu/."""
    import difflib

    from sanafe_tpu_torch import native

    ours = REPO / "sanafe_tpu_torch" / "csrc" / name
    theirs = REPO / "sanafe_tpu" / "native_src" / name
    assert native._SRC == REPO / "sanafe_tpu_torch" / "csrc" / "scheduler.cpp"
    lines = ours.read_text().splitlines()
    if name == "scheduler.cpp":
        begin = lines.index("// sanafe_tpu_torch only: begin spike_rows")
        end = lines.index("// sanafe_tpu_torch only: end spike_rows")
        assert any(line.startswith("int64_t spike_rows(")
                   for line in lines[begin:end])
        # the block and the blank line before it
        lines = lines[:begin - 1] + lines[end + 1:]
    diff = [
        line for line in difflib.ndiff(
            theirs.read_text().splitlines(), lines)
        if line[:2] in ("+ ", "- ")
    ]
    expected = ["+ #include <cstdio>"] if name == "scheduler.cpp" else []
    assert diff == expected
    text = (REPO / "sanafe_tpu_torch" / "native.py").read_text()
    assert "native_src" not in text and '"sanafe_tpu"' not in text


def _too_big(mod):
    # 400 neurons pad to 512 lanes: the extended matrix exceeds 5 MiB
    return random_chip(mod, cores=8, neurons_per_core=50,
                       n_log_potential=0)


def _plugin_soma(mod):
    """The example chip with its somas swapped for a plugin model."""
    arch, net = example_chip(mod)
    for core in arch.cores():
        for unit in core.pipeline_hw:
            if unit.implements_soma:
                unit.model_info.plugin_library_path = "libhh.so"
                unit.model_info.name = "hodgkin_huxley_plugin"
    return arch, net


def _conv_chip(mod):
    """A conv2d hyperedge lowered through the structured (bulk) path, so
    sanafe_tpu would deliver it by a strided convolution."""
    Attribute = mod.Attribute
    arch = mod.load_loihi()
    net = mod.SpikingNetwork("conv")
    layer = mod.NeuronConfiguration(model_attributes={
        "threshold": Attribute(2.0), "bias": Attribute(1.0)})
    g0 = net.create_neuron_group("g0", 2 * 8 * 8, layer)
    g1 = net.create_neuron_group("g1", 3 * 6 * 6, layer)
    g0.connect_neurons_conv2d(
        g1, {"weight": [Attribute(1.0)] * (3 * 3 * 2 * 3)},
        mod.network.Conv2DParameters(
            input_width=8, input_height=8, input_channels=2, kernel_width=3,
            kernel_height=3, kernel_count=3),
    )
    cores = arch.cores()
    for g, core in ((g0, cores[0]), (g1, cores[1])):
        for neuron in g:
            neuron.map_to_core(core)
    return arch, net


@pytest.mark.parametrize("request_kind", [
    "plugin_soma", "device_sweep", "mesh", "conv_delivery",
])
def test_requests_outside_the_slice_raise(tmp_path, monkeypatch,
                                          request_kind):
    kwargs = {
        "plugin_soma": {},
        # scale-out is ported (tests/test_torch_parallel.py): a mesh that
        # is not a one-dimensional DeviceMesh is refused, with or without
        # the device sweep
        "device_sweep": {"device_sweep": True, "mesh": object()},
        "mesh": {"mesh": object()},
        # float64 keeps the chip off the fused dense delivery
        "conv_delivery": {"perf_trace": True},
    }[request_kind]
    if request_kind == "conv_delivery":
        # conv2d delivery was outside the earlier slices; it is ported now
        # (ops/conv.py), so the request runs on the step scan and matches
        # sanafe_tpu's float64 scan (tests/test_torch_dvs.py holds the rest)
        import sanafe_tpu.network as jax_network
        import sanafe_tpu_torch.network as port_network

        monkeypatch.setattr(port_network, "BULK_EDGE_THRESHOLD", 1)
        monkeypatch.setattr(jax_network, "BULK_EDGE_THRESHOLD", 1)
        chip = loaded(st, _conv_chip, device="cpu", dtype=torch.float64)
        assert chip.compiled.conv_specs
        b = chip.sim(10, heartbeat=0, **kwargs)
        a = loaded(sf, _conv_chip).sim(10, heartbeat=0, **kwargs)
        assert b["device_engine"] == "scan" and a["spikes"] > 0
        assert_match(a, b, 1e-12)
        return
    if request_kind == "plugin_soma":
        # plugin somas are ported now (tests/test_torch_plugins.py): an
        # unregistered model whose plugin is a native library is refused as
        # sanafe_tpu refuses it, naming register_soma_model
        for mod, kw in ((sf, {}), (st, {"device": "cpu"})):
            with pytest.raises(RuntimeError, match="register_soma_model"):
                loaded(mod, _plugin_soma, **kw)
        return
    chip = loaded(st, example_chip, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        chip.sim(10, heartbeat=0, **kwargs)
    assert chip._mesh is None and chip.total_timesteps == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ineligible_chip_runs_on_the_scan(f64, dtype):
    """A chip over the whole-chunk engine's 384 neurons runs on the step
    scan, in both dtypes, with the same rasters and counters as
    sanafe_tpu's float64 scan."""
    a = loaded(sf, _too_big).sim(60, heartbeat=0, spike_trace=True)
    b = loaded(st, _too_big, device="cpu", dtype=dtype).sim(
        60, heartbeat=0, spike_trace=True)
    assert b["device_engine"] == "scan"
    assert a["spikes"] > 0
    assert_match(a, b, 1e-12 if dtype == torch.float64 else 1e-6)
    assert [[(n.group_name, n.neuron_offset) for n in step]
            for step in a["spike_trace"].data] == [
        [(n.group_name, n.neuron_offset) for n in step]
        for step in b["spike_trace"].data]


@pytest.mark.parametrize("timing_model", ["detailed", "simple"])
def test_perf_trace_runs_on_the_scan(f64, tmp_path, timing_model):
    """The perf trace takes the step scan; perf.csv is byte-identical to
    sanafe_tpu's in float64 (exact per-event energies), and the chip's
    state carries across engines within one chip."""
    files = []
    for mod, kw in ((sf, {}), (st, {"device": "cpu",
                                    "dtype": torch.float64})):
        chip = loaded(mod, example_chip, **kw)
        path = tmp_path / f"{mod.__name__}_perf.csv"
        result = chip.sim(30, timing_model=timing_model, heartbeat=0,
                          chunk=30)
        perf = chip.sim(30, timing_model=timing_model, heartbeat=0,
                        chunk=30, perf_trace=path)
        chip.close()
        files.append(path.read_bytes())
        if mod is st:
            assert result["device_engine"] == "chunk_plain"
            assert perf["device_engine"] == "scan"
    assert files[0] == files[1]
    assert files[1].startswith(b"timestep,fired,updated,packets,hops")
    assert files[1].count(b"\n") == 31


def test_yaml_front_ends_raise(tmp_path, monkeypatch):
    """The YAML front-ends are ported; without PyYAML, reading a YAML
    description raises ImportError naming it, while writing one needs no
    PyYAML."""
    from sanafe_tpu_torch.arch import load_arch
    from sanafe_tpu_torch.network import load_net

    arch, net = st.load_example()
    net.save(tmp_path / "snn.yaml")
    (tmp_path / "arch.yaml").write_text("architecture: {}\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_arch(tmp_path / "arch.yaml")
    with pytest.raises(ImportError, match="PyYAML"):
        load_net(tmp_path / "snn.yaml", arch)
    net.save(tmp_path / "again.yaml")
    assert (tmp_path / "again.yaml").read_text() == (
        tmp_path / "snn.yaml").read_text()


def test_device_is_never_moved_to_the_cpu():
    """No device argument means CUDA; without CUDA that raises instead of
    falling back to the CPU."""
    arch, _ = st.load_example()
    if torch.cuda.is_available():
        assert st.SpikingChip(arch).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            st.SpikingChip(arch)
