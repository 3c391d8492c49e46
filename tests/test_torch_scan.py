"""The port's step scan (sanafe_tpu_torch/ops/scan.py) against sanafe_tpu's
(``DeviceProgram.make_scan``), on chips built by one recipe in both packages
(tests/test_torch_chips.py), under the ROADMAP parity contract:

- float64 lane (x64 on, as tests/conftest.py sets it): fired/updated masks
  and counters identical; every trace CSV, perf.csv included,
  byte-identical; energies and the simple-timing sim_time within 1e-12
  relative (per-step device sums are added in another order). Potentials
  and state are identical, except on the multitap chip: XLA's CPU backend
  contracts the cable update ``taps * tc + flow`` into a fused multiply-add,
  which rounds once where the port (like the reference C++) rounds twice,
  so there they agree within 1e-12 * max(1, |v|) (ROADMAP.md section 3);
- float32 lane (x64 off): the tests/test_pallas_chunk.py bars: masks,
  counters and spikes.csv exact, energies and sim_time within 1e-6
  relative, potentials within 1e-6 * max(1, |v|). Where the stats come
  from the fused float32 roll-up product, the port's per-step stats are
  held to the float64 value of the same product over the same (identical)
  masks: within 1e-6 relative, or no farther than sanafe_tpu's. A float32
  sum of a few hundred equal terms is itself up to 1.3e-6 off (both
  packages, 384-neuron chip), and two sums in different orders differ by
  both errors together (1.003e-6 between the packages on random2048).

The port runs on the CPU, where the delivery kernel's wrapper takes its
plain version; ``use_kernel=True`` builds the kernel-shaped program, whose
every step delivers through the live-row list, or the cell list where the
rows are sparse (``delivery_launch`` on the program's plan:
``delivery_live_plain``'s order, ``delivery_cells_plain``'s the same).

sanafe_tpu's scan of a chip is run once a process for each lane
(``jax_scan``): the ``use_kernel`` cases of one chip compare against the
same reference.
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import sanafe_tpu as sf
import sanafe_tpu_torch as st
from sanafe_tpu_torch.ops import delivery as port_delivery
from sanafe_tpu_torch.ops.delivery import CellBlocks
from sanafe_tpu_torch.ops.scan import rollup_stats, run_scan
from sanafe_tpu_torch.ops.step import _timestep
from sanafe_tpu_torch.ops.step import make_device_program as port_program

from test_torch_chips import ALL_CHIPS, DEFAULT_THREADS, compile_both

FLAGS = dict(record_fired_axons=True, record_potentials=True,
             record_spikes=True, record_u=True)
STEPS = 120  # one chunk in both packages (below the 128-step taper)
F64_REL = 1e-12
F32_REL = 1e-6


@pytest.fixture()
def f32(monkeypatch):
    """sanafe_tpu's float32 lane: x64 off; on the CPU it runs the scan."""
    monkeypatch.delenv("SANAFE_PALLAS_CHUNK", raising=False)
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture()
def f64(monkeypatch):
    monkeypatch.delenv("SANAFE_PALLAS_CHUNK", raising=False)
    assert jax.config.jax_enable_x64


def make_feeds(compiled, n_steps, seed=0):
    """Seeded stand-ins for the host RNG feeds (TrueNorth LFSR draws,
    Poisson input spikes)."""
    rng = np.random.default_rng(seed)
    feeds = {}
    if compiled.tn_noise_slots is not None and len(compiled.tn_noise_slots):
        masks = np.asarray(compiled.tn_noise_masks, dtype=np.int64)
        draws = rng.integers(0, 2**31, (n_steps, len(masks)))
        feeds["tn_noise"] = (draws & masks[None, :]).astype(np.float64)
    if compiled.has_poisson:
        total = sum(len(members) for _, members in compiled.input_units)
        feeds["poisson"] = rng.random((n_steps, total)) < 0.3
    return feeds


def through_the_list(monkeypatch):
    """Record the plan of every ``delivery_launch`` the port's step makes
    (the kernel-delivery programs' block delivery); returns the list."""
    plans = []
    launch = port_delivery.delivery_launch

    def recorded(fired_tiles, plan):
        plans.append(plan)
        return launch(fired_tiles, plan)

    monkeypatch.setattr(port_delivery, "delivery_launch", recorded)
    return plans


def assert_through_the_list(pprog, plans, steps=STEPS):
    """A kernel-delivery program delivered every step through its list (of
    live rows, or of cells where its rows are sparse)."""
    if not pprog.kernel_delivery:
        assert not plans
        return
    blk = pprog.block
    held = blk.cells if isinstance(blk, CellBlocks) else blk.live_rows
    assert held.count > 0
    assert len(plans) == steps and all(p is blk.plan for p in plans)


def read_only(arrays: dict) -> dict:
    """``arrays`` as numpy arrays that cannot be written."""
    out = {k: np.array(v) for k, v in arrays.items()}
    for v in out.values():
        v.setflags(write=False)
    return out


@functools.cache
def jax_scan(name: str, steps: int, x64: bool):
    """sanafe_tpu's half of ``scan_both``, once a process for each chip,
    length and lane (x64 on or off): the program's choices, and the state
    and outputs of the chunk, read-only."""
    from sanafe_tpu.ops.step import make_device_program as jax_program

    assert x64 == jax.config.jax_enable_x64
    jax_compiled, _ = compile_both(name)
    jprog = jax_program(jax_compiled, **FLAGS)
    jstate, jout = jprog.make_scan(steps)(
        jprog.init_state(), np.int64(1), make_feeds(jax_compiled, steps))
    choices = SimpleNamespace(
        fused_rollup=jprog.fused_rollup, n_stats_cols=jprog.n_stats_cols,
        dense_delivery=jprog.dense_delivery, arrays=frozenset(jprog.arrays))
    return choices, read_only(jstate), read_only(jout)


def scan_both(name, dtype, use_kernel=None, steps=STEPS):
    """One chunk of ``steps`` from the initial state through both scans."""
    from sanafe_tpu_torch.compile import compile_chip

    jprog, jstate, jout = jax_scan(name, steps, jax.config.jax_enable_x64)
    port_compiled = compile_chip(*ALL_CHIPS[name](st))
    pprog = port_program(port_compiled, "cpu", dtype, use_kernel=use_kernel,
                         **FLAGS)
    pstate, pout = run_scan(pprog, pprog.init_state(), 1, steps,
                            make_feeds(port_compiled, steps))
    return (jprog, pprog, jstate, jout,
            {k: v.numpy() for k, v in pstate.items()},
            {k: v.numpy() for k, v in pout.items()})


def assert_rel(a, b, rel, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    assert np.all(np.abs(a - b) <= rel * np.maximum(np.abs(a), 1e-30)), what


def assert_v(a, b, rel, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    assert np.all(np.abs(a - b) <= rel * np.maximum(1.0, np.abs(a))), what


# chips whose float64 step XLA contracts into fused multiply-adds
FMA_CHIPS = {"multitap"}


def float64_rollup(prog, masks):
    """The fused roll-up's stats evaluated in float64 over ``masks``: the
    float32 program's matrix and constants, exactly widened."""
    n = prog.compiled.n_neurons
    planes = [
        torch.from_numpy(np.unpackbits(masks[:, k, :], axis=1)[:, :n]).double()
        for k in (0, 1)
    ]
    wide = {key: prog.arrays[key].double()
            for key in ("rollup_matrix", "rollup_const")}
    return rollup_stats(prog, wide, *planes)[0].numpy()


def assert_scan_match(jstate, jout, pstate, pout, f64_lane, exact=True,
                      pprog=None):
    assert sorted(jout) == sorted(pout)
    for key in jout:
        assert jout[key].dtype == pout[key].dtype, key
        assert jout[key].shape == pout[key].shape, key
    np.testing.assert_array_equal(jout["masks_packed"], pout["masks_packed"])
    np.testing.assert_array_equal(
        np.round(jout["stats"][:, :5]), np.round(pout["stats"][:, :5])
    )
    if f64_lane:
        assert_rel(jout["stats"][:, 5:], pout["stats"][:, 5:], F64_REL,
                   "stats")
    elif pprog is not None and pprog.fused_rollup:
        ref = float64_rollup(pprog, pout["masks_packed"])[:, 5:]
        port_err = np.abs(pout["stats"][:, 5:] - ref)
        jax_err = np.abs(jout["stats"][:, 5:] - ref)
        assert np.all(port_err <= np.maximum(F32_REL * np.abs(ref), jax_err))
    else:
        assert_rel(jout["stats"][:, 5:], pout["stats"][:, 5:], F32_REL,
                   "stats")
    for key in ("refractory", "buffer_valid"):
        np.testing.assert_array_equal(jstate[key], pstate[key], key)
    pairs = [(jout[key], pout[key], key) for key in ("potential_log", "u_log")]
    pairs += [(jstate[key], pstate[key], key) for key in jstate
              if key not in ("refractory", "buffer_valid")]
    for a, b, key in pairs:
        if f64_lane and exact:
            np.testing.assert_array_equal(a, b, key)
        else:
            assert_v(a, b, F64_REL if f64_lane else F32_REL, key)


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("name", sorted(ALL_CHIPS))
def test_scan_matches_jax_float64(f64, monkeypatch, name, use_kernel):
    plans = through_the_list(monkeypatch)
    jprog, pprog, jstate, jout, pstate, pout = scan_both(
        name, torch.float64, use_kernel
    )
    assert pprog.kernel_delivery == bool(use_kernel and pprog.block is not None
                                         and pprog.block.n_blocks)
    assert_through_the_list(pprog, plans)
    assert int(np.round(jout["stats"][:, 4]).sum()) > 0  # the chip fires
    assert_scan_match(jstate, jout, pstate, pout, f64_lane=True,
                      exact=name not in FMA_CHIPS)


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("name", ["random", "random1024", "random2048",
                                  "delay", "multitap"])
def test_scan_matches_jax_float32(f32, monkeypatch, name, use_kernel):
    """Covers the fused roll-up with dense delivery (random), with block_wc
    (random1024) and with the einsum delivery (random2048), each deferred
    to one batched roll-up after the loop; with ``use_kernel=True``, the
    delivery through the live-row list."""
    plans = through_the_list(monkeypatch)
    jprog, pprog, jstate, jout, pstate, pout = scan_both(
        name, torch.float32, use_kernel
    )
    assert_through_the_list(pprog, plans)
    assert pprog.kernel_delivery == bool(use_kernel and pprog.block
                                         is not None)
    for flag in ("fused_rollup", "n_stats_cols"):
        assert getattr(jprog, flag) == getattr(pprog, flag), flag
    if not use_kernel:
        assert jprog.dense_delivery == pprog.dense_delivery
        assert ("block_wc" in jprog.arrays) == ("block_wc" in pprog.arrays)
    assert_scan_match(jstate, jout, pstate, pout, f64_lane=False,
                      pprog=pprog)


def test_program_choices_match_jax(f32):
    """The JAX package's rules pick the same roll-up and delivery shape."""
    from sanafe_tpu.ops.step import make_device_program as jax_program

    seen = set()
    for name in ("random", "random1024", "random2048", "delay"):
        jax_compiled, port_compiled = compile_both(name)
        jprog = jax_program(jax_compiled)
        pprog = port_program(port_compiled, "cpu", torch.float32)
        shape = (jprog.fused_rollup, jprog.dense_delivery,
                 "block_wc" in jprog.arrays, jprog.block is not None)
        assert shape == (pprog.fused_rollup, pprog.dense_delivery,
                         "block_wc" in pprog.arrays, pprog.block is not None)
        for key in ("rollup_matrix", "rollup_const", "block_wc"):
            if key in jprog.arrays:
                np.testing.assert_array_equal(
                    np.asarray(jprog.arrays[key]), pprog.arrays[key].numpy(),
                    err_msg=f"{name} {key}")
        seen.add(shape)
    assert len(seen) == 4  # dense, block_wc, einsum, scatter


@pytest.mark.parametrize("threads", ["one", "default"])
def test_per_step_fused_rollup_equals_deferred(f32, threads):
    """_timestep's per-step fused roll-up gives the batched roll-up's
    stats row for row (same matrix, same rows), on one torch thread and on
    torch's default count: a float32 product's order of adds follows the
    BLAS's threads."""
    _, port_compiled = compile_both("random2048")
    prog = port_program(port_compiled, "cpu", torch.float32, **FLAGS)
    assert prog.fused_rollup and not prog.dense_delivery
    saved = torch.get_num_threads()
    torch.set_num_threads(1 if threads == "one" else DEFAULT_THREADS)
    try:
        state = prog.init_state()
        rows, planes = [], []
        for t in range(1, 21):
            new_state, out = _timestep(prog, prog.arrays, state, t)
            _, deferred = _timestep(prog, prog.arrays, state, t,
                                    defer_rollup=True)
            rows.append(out["stats"])
            planes.append((deferred["fired_plane"], deferred["upd_plane"]))
            state = new_state
        fired = torch.stack([p[0] for p in planes]).to(torch.float32)
        upd = torch.stack([p[1] for p in planes]).to(torch.float32)
        stats, _ = rollup_stats(prog, prog.arrays, fired, upd)
    finally:
        torch.set_num_threads(saved)
    np.testing.assert_allclose(torch.stack(rows).numpy(), stats.numpy(),
                               rtol=1e-6)
    assert stats[:, 4].sum() > 0


# --- through SpikingChip.sim, traces to files --------------------------------

TRACES = ("spikes", "potential", "perf", "messages")


def sim_both(name, tmp_path, dtype, timing_model, traces, steps=STEPS):
    """The named chip through both packages' SpikingChip, ``traces`` (a
    subset of TRACES) streamed to CSV files under ``tmp_path``."""
    runs, files = [], []
    for mod, kw in ((sf, {}), (st, {"device": "cpu", "dtype": dtype})):
        arch, net = ALL_CHIPS[name](mod)
        chip = mod.SpikingChip(arch, **kw)
        chip.load(net)
        paths = {t: tmp_path / f"{mod.__name__}_{t}.csv" for t in traces}
        result = chip.sim(
            steps, timing_model=timing_model, heartbeat=0, chunk=steps,
            spike_trace=paths.get("spikes"),
            potential_trace=paths.get("potential"),
            perf_trace=paths.get("perf"),
            message_trace=paths.get("messages"),
        )
        chip.close()
        runs.append(result)
        files.append({t: p.read_bytes() for t, p in paths.items()})
    return runs, files


def assert_results(a, b, rel, exact_sim_time):
    for k in ("spikes", "neurons_fired", "neurons_updated", "packets_sent"):
        assert a[k] == b[k], k
    for k in a["energy"]:
        ref = a["energy"][k]
        assert abs(ref - b["energy"][k]) <= rel * max(abs(ref), 1e-30), k
    if exact_sim_time:
        assert a["sim_time"] == b["sim_time"]
    else:
        ref = a["sim_time"]
        assert abs(ref - b["sim_time"]) <= rel * max(abs(ref), 1e-30)


F64_CASES = [
    # (chip, timing model, traces): the perf trace puts the small chips on
    # the scan; the others are too large or have per-edge dendrite state
    ("example", "detailed", TRACES),
    ("truenorth", "detailed", ("spikes", "potential", "perf")),
    ("random", "simple", ("spikes", "potential", "perf")),
    ("random1024", "simple", ("spikes", "potential", "perf")),
    ("random2048", "detailed", ("spikes", "potential", "perf")),
    ("delay", "detailed", TRACES),
    ("multitap", "simple", ("spikes", "potential", "perf")),
    ("multitap", "cycle", ("spikes", "potential")),
    ("stochastic", "detailed", TRACES),
    ("stochastic", "simple", ("spikes", "potential", "perf")),
]


@pytest.mark.parametrize("name,timing_model,traces", F64_CASES)
def test_sim_matches_jax_float64(f64, tmp_path, name, timing_model, traces):
    (a, b), (files_a, files_b) = sim_both(name, tmp_path, torch.float64,
                                          timing_model, traces)
    assert b["device_engine"] == "scan"
    assert a["spikes"] > 0
    assert_results(a, b, F64_REL, exact_sim_time=timing_model != "simple")
    for trace in traces:
        assert files_a[trace] == files_b[trace], trace
    if "perf" in traces:
        assert files_b["perf"].count(b"\n") == STEPS + 1


F32_CASES = [
    ("random1024", "simple"),
    ("random2048", "detailed"),
    ("delay", "simple"),
    ("multitap", "detailed"),
    ("example", "simple"),
    ("stochastic", "detailed"),
]


@pytest.mark.parametrize("name,timing_model", F32_CASES)
def test_sim_matches_jax_float32(f32, tmp_path, name, timing_model):
    (a, b), (files_a, files_b) = sim_both(
        name, tmp_path, torch.float32, timing_model, ("spikes", "perf")
    )
    assert b["device_engine"] == "scan"
    assert a["spikes"] > 0
    assert_results(a, b, F32_REL, exact_sim_time=timing_model == "detailed")
    assert files_a["spikes"] == files_b["spikes"]
    # perf.csv rows: the same columns and counters; energies to the bars
    rows_a = [r.split(",") for r in files_a["perf"].decode().splitlines()]
    rows_b = [r.split(",") for r in files_b["perf"].decode().splitlines()]
    assert rows_a[0] == rows_b[0] and len(rows_a) == len(rows_b) == STEPS + 1
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        assert ra[:6] == rb[:6]
        assert_rel([float(x) for x in ra[6:]], [float(x) for x in rb[6:]],
                   F32_REL, "perf row")


def test_perf_trace_in_memory(f64):
    """The in-memory perf trace holds the same columns and values."""
    traces = []
    for mod, kw in ((sf, {}), (st, {"device": "cpu",
                                    "dtype": torch.float64})):
        arch, net = ALL_CHIPS["example"](mod)
        chip = mod.SpikingChip(arch, **kw)
        chip.load(net)
        traces.append(chip.sim(40, heartbeat=0, chunk=40,
                               perf_trace=True)["perf_trace"])
    a, b = traces
    assert sorted(a.keys()) == sorted(b.keys())
    for key in a.keys():
        assert a[key] == b[key], key


def test_delay_state_carried_from_jax_checkpoint(f64, tmp_path):
    """A sanafe_tpu .npz checkpoint of the delay chip, delay ring included,
    carries into the port: both then run 50 more steps alike."""
    arch, net = ALL_CHIPS["delay"](sf)
    jchip = sf.SpikingChip(arch)
    jchip.load(net)
    jchip.sim(8, heartbeat=0, chunk=8)
    ckpt = tmp_path / "state.npz"
    jchip.save_state(ckpt)
    arch, net = ALL_CHIPS["delay"](st)
    pchip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    pchip.load(net)
    with np.load(ckpt) as data:
        assert "delay_ring" in data.files
        assert np.any(data["delay_ring"] != 0)
        pchip.load_state_arrays(dict(data))
    assert pchip.total_timesteps == 8
    a = jchip.sim(50, heartbeat=0, chunk=50, spike_trace=True,
                  potential_trace=True)
    b = pchip.sim(50, heartbeat=0, chunk=50, spike_trace=True,
                  potential_trace=True)
    assert a["timestep_start"] == b["timestep_start"] == 9
    assert a["spikes"] > 0
    assert_results(a, b, F64_REL, exact_sim_time=True)
    assert a["potential_trace"].data == b["potential_trace"].data
    assert [[(n.group_name, n.neuron_offset) for n in step]
            for step in a["spike_trace"].data] == [
        [(n.group_name, n.neuron_offset) for n in step]
        for step in b["spike_trace"].data]
