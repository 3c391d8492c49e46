"""Whole-chunk engine of the port (sanafe_tpu_torch/ops/chunk.py) against
sanafe_tpu's Pallas kernel (ops/pallas_chunk.py).

The JAX side runs as tests/test_pallas_chunk.py runs it on the CPU: float32
(x64 off) and ``make_pallas_chunk(..., interpret=True)``. The port's plain
version ``chunk_plain`` must give the same plan and the same chunk outputs on
the same inputs, to these bars (the JAX kernel's own, set by
tests/test_pallas_chunk.py):

- counters, fired/updated masks and spike-log bytes: exact;
- energy and sim_time sums: 1e-6 relative (both sum in Kahan float32, but
  the two matvecs add the active rows in different orders);
- potential and u logs, and the state: 1e-6 * max(1, |v|).

The ``cuda`` tests hold the CUDA kernel to ``chunk_plain`` on the card, to
the same bars and, across cluster sizes, bit for bit (every cluster size,
even and ragged column slices, a chunk of one step, Npad 512); they skip
where there is no card. JAX is imported inside the
tests that use it, so this file also runs on a machine with only the port:
``python -m pytest tests/test_torch_chunk.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from sanafe_tpu_torch.ops import chunk as port_chunk
from sanafe_tpu_torch.ops.step import make_device_program as port_program

from test_torch_chips import CHIPS, compile_both

FLAGS = dict(record_fired_axons=True, record_potentials=True,
             record_spikes=True, record_u=True)
T = 100
T0 = 1


@pytest.fixture()
def f32():
    """The Pallas kernel is float32-only; flip the test env to f32."""
    import jax

    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_feeds(compiled, n_steps, seed=0):
    """Seeded stand-ins for the host RNG feeds (TrueNorth LFSR draws)."""
    rng = np.random.default_rng(seed)
    feeds = {}
    if compiled.tn_noise_slots is not None and len(compiled.tn_noise_slots):
        masks = np.asarray(compiled.tn_noise_masks, dtype=np.int64)
        draws = rng.integers(0, 2**31, (n_steps, len(masks)))
        feeds["tn_noise"] = (draws & masks[None, :]).astype(np.float64)
    assert not compiled.has_poisson
    return feeds


def run_port(prog, state, feeds, t0=T0, n_steps=T, **kernel_args):
    """One chunk through the port's wrapper on the program's device."""
    plan = port_chunk.plan_chunk(prog)
    mats = port_chunk.chunk_tensors(plan, prog.device)
    rows = port_chunk.state_rows(plan, state, prog.dtype)
    spike_plane, add_plane = port_chunk.build_planes(
        prog, plan, n_steps, t0, feeds
    )
    rows_out, packed = port_chunk.chunk_kernel(
        plan, mats, rows, t0, n_steps, spike_plane, add_plane, **kernel_args
    )
    dec = port_chunk.decode_packed(
        packed.cpu().numpy(),
        port_chunk.packed_layout(plan, n_steps, prog.dtype),
    )
    new_state = port_chunk.state_from_rows(plan, rows_out)
    return dec, {k: v.cpu().numpy() for k, v in new_state.items()}


def assert_close(a, b, key):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, key
    assert np.all(np.abs(a - b) <= 1e-6 * np.maximum(1.0, np.abs(a))), key


def assert_chunk_match(a, b, state_a, state_b, sum_tol=1e-6):
    np.testing.assert_array_equal(a["counter_sums"], b["counter_sums"])
    np.testing.assert_array_equal(a["masks_packed"], b["masks_packed"])
    np.testing.assert_array_equal(a["spike_log_packed"],
                                  b["spike_log_packed"])
    for i, ref in enumerate(a["energy_sums"]):
        assert abs(ref - b["energy_sums"][i]) <= sum_tol * max(abs(ref),
                                                               1e-30)
    ref = a["sim_time_sum"]
    assert abs(ref - b["sim_time_sum"]) <= sum_tol * max(abs(ref), 1e-30)
    assert_close(a["potential_log"], b["potential_log"], "potential_log")
    assert_close(a["u_log"], b["u_log"], "u_log")
    for key in ("refractory", "buffer_valid"):
        np.testing.assert_array_equal(state_a[key], state_b[key], key)
    for key in ("potential", "input_current", "buffer_current"):
        assert_close(state_a[key], state_b[key], key)


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_plan_matches_jax(f32, name):
    """Same eligibility and the same matrix, const and parameter planes."""
    from sanafe_tpu.ops.pallas_chunk import plan_chunk as jax_plan
    from sanafe_tpu.ops.step import make_device_program as jax_program

    jax_compiled, port_compiled = compile_both(name)
    jp = jax_plan(jax_program(jax_compiled, **FLAGS))
    pp = port_chunk.plan_chunk(
        port_program(port_compiled, "cpu", torch.float32, **FLAGS)
    )
    assert jp is not None and pp is not None
    for key in ("matrix", "const", "params"):
        a, b = getattr(jp, key), getattr(pp, key)
        assert a.dtype == b.dtype == np.float32, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    for key in ("n", "npad", "nbytes", "n_cores", "g_lat", "g_msg",
                "g_deliver", "g_count", "g_pack_fired", "g_pack_upd",
                "g_spike", "sbytes", "m_cols", "n_plog", "n_ulog",
                "need_spike_plane", "need_add_plane", "sync_delay",
                "models"):
        assert getattr(jp, key) == getattr(pp, key), key
    # the JAX kernel's 0/1 selection matvec picks exactly the gathered lanes
    sel = jp.log_sel
    assert sel is not None
    n_log = jp.n_plog + jp.n_ulog
    np.testing.assert_array_equal(sel[:, :n_log].sum(axis=0), 1.0)
    np.testing.assert_array_equal(
        np.argmax(sel[:, :n_log], axis=0), pp.log_index
    )


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_chunk_plain_matches_jax_kernel(f32, name):
    """chunk_plain (float32, CPU) equals the JAX kernel run in interpret
    mode over one 100-step chunk from the initial state."""
    from sanafe_tpu.ops.pallas_chunk import decode_packed as jax_decode
    from sanafe_tpu.ops.pallas_chunk import make_pallas_chunk
    from sanafe_tpu.ops.step import make_device_program as jax_program

    jax_compiled, port_compiled = compile_both(name)
    jprog = jax_program(jax_compiled, **FLAGS)
    run = make_pallas_chunk(jprog, T, ts_block=T, interpret=True)
    assert run is not None
    feeds = make_feeds(jax_compiled, T)
    state0 = {k: np.asarray(v) for k, v in jprog.init_state().items()}
    jstate, jout = run(state0, T0, feeds)
    a = jax_decode(np.asarray(jout["packed"]), jout["packed_layout"])

    pprog = port_program(port_compiled, "cpu", torch.float32, **FLAGS)
    b, pstate = run_port(
        pprog, {k: torch.tensor(v) for k, v in state0.items()}, feeds
    )
    assert a["counter_sums"][4] > 0  # the chunk fires
    assert_chunk_match(
        a, b, {k: np.asarray(v) for k, v in jstate.items()}, pstate
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CHIPS))
def test_chunk_kernel_matches_plain(cuda, name):
    """The CUDA kernel against chunk_plain on CPU copies of its inputs."""
    chip = CHIPS[name]
    from sanafe_tpu_torch.compile import compile_chip

    import sanafe_tpu_torch

    compiled = compile_chip(*chip(sanafe_tpu_torch))
    feeds = make_feeds(compiled, T)
    results = []
    for device in ("cpu", cuda):
        prog = port_program(compiled, device, torch.float32, **FLAGS)
        before = port_chunk.chunk_kernel.launches
        results.append(run_port(prog, prog.init_state(), feeds))
        launched = port_chunk.chunk_kernel.launches - before
        assert launched == (1 if prog.device.type == "cuda" else 0)
    (a, state_a), (b, state_b) = results
    assert_chunk_match(a, b, state_a, state_b)


def assert_chunk_identical(a, b, state_a, state_b):
    """Every output equal bit for bit."""
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for key in state_a:
        np.testing.assert_array_equal(state_a[key], state_b[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_one_step_chunks_chain_to_one_chunk(name):
    """chunk_plain over T one-step chunks, the state carried between them,
    gives the masks, spike bytes, logs and final state of one T-step chunk
    (exact: the same operations in the same order), and the same counter
    sums."""
    _, port_compiled = compile_both(name)
    steps = 12
    feeds = make_feeds(port_compiled, steps)
    prog = port_program(port_compiled, "cpu", torch.float32, **FLAGS)
    whole, whole_state = run_port(prog, prog.init_state(), feeds,
                                  n_steps=steps)
    state = prog.init_state()
    parts = []
    for j in range(steps):
        step_feeds = {k: v[j : j + 1] for k, v in feeds.items()}
        dec, new_state = run_port(prog, state, step_feeds, t0=T0 + j,
                                  n_steps=1)
        parts.append(dec)
        state = {k: torch.from_numpy(np.asarray(v))
                 for k, v in new_state.items()}
    for key in ("masks_packed", "spike_log_packed", "potential_log",
                "u_log"):
        np.testing.assert_array_equal(
            np.concatenate([p[key] for p in parts]), whole[key], err_msg=key)
    np.testing.assert_array_equal(
        sum(p["counter_sums"] for p in parts), whole["counter_sums"])
    for key, value in whole_state.items():
        np.testing.assert_array_equal(new_state[key], value, err_msg=key)


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_default_cluster_follows_chip_size(name):
    """The kernel's cluster size comes from the plan alone: the largest
    cluster unless the chip's busiest step adds under TINY_STEP_BYTES of
    matrix rows (then one CTA, no cluster barrier); and the plan's columns
    cut into 16-byte chunks."""
    _, port_compiled = compile_both(name)
    plan = port_chunk.plan_chunk(
        port_program(port_compiled, "cpu", torch.float32, **FLAGS))
    size = port_chunk.default_cluster(plan)
    tiny = 2 * plan.n * plan.m_cols * 4 <= port_chunk.TINY_STEP_BYTES
    assert size == (1 if tiny else port_chunk.MAX_CLUSTER)
    assert tiny == (name != "random")
    assert plan.m_cols % 4 == 0


def _cuda_runs(compiled, cuda, n_steps, clusters):
    """chunk_plain on the CPU, then the kernel at each cluster size."""
    feeds = make_feeds(compiled, n_steps)
    prog = port_program(compiled, "cpu", torch.float32, **FLAGS)
    plain = run_port(prog, prog.init_state(), feeds, n_steps=n_steps)
    prog = port_program(compiled, cuda, torch.float32, **FLAGS)
    runs = []
    for size in clusters:
        before = port_chunk.chunk_kernel.launches
        runs.append(run_port(prog, prog.init_state(), feeds, n_steps=n_steps,
                             cluster=size))
        assert port_chunk.chunk_kernel.launches == before + 1
    torch.cuda.synchronize()
    return plain, runs


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [1, 37])
@pytest.mark.parametrize("name", sorted(CHIPS))
def test_chunk_kernel_cluster_sizes(cuda, name, n_steps):
    """Every cluster size 1..16 (most cut M's 16-byte chunks unevenly, and
    sizes over M/4 leave CTAs with no column) gives the same bits, and
    they meet chunk_plain; also over a chunk of a single step."""
    import sanafe_tpu_torch
    from sanafe_tpu_torch.compile import compile_chip

    compiled = compile_chip(*CHIPS[name](sanafe_tpu_torch))
    plain, runs = _cuda_runs(compiled, cuda, n_steps, range(1, 17))
    a, state_a = plain
    for b, state_b in runs:
        assert_chunk_match(a, b, state_a, state_b)
        assert_chunk_identical(runs[0][0], b, runs[0][1], state_b)


@pytest.mark.cuda
def test_chunk_kernel_npad_512(cuda, monkeypatch):
    """400 neurons pad to 512 lanes, the widest the kernel takes (1024
    threads hold the 2 * Npad lhs rows); plan_chunk turns the chip away only
    for the matrix budget it shares with sanafe_tpu, lifted here. The
    energy sums are held to 1e-5 relative: a step adds some 800 float32
    rows, the kernel in row order and chunk_plain's matmul on the CPU in
    its own (measured 1.5e-6 apart on an H100), and the Kahan sums only
    compensate across steps. Across cluster sizes every bit is equal."""
    import sanafe_tpu_torch
    from sanafe_tpu_torch.compile import compile_chip

    from test_torch_chips import random_chip

    monkeypatch.setattr(port_chunk, "MAX_MATRIX_BYTES", 8 << 20)
    compiled = compile_chip(*random_chip(
        sanafe_tpu_torch, cores=8, neurons_per_core=50, n_log_potential=16))
    (a, state_a), runs = _cuda_runs(compiled, cuda, 25, (1, 5, 16))
    for b, state_b in runs:
        assert_chunk_match(a, b, state_a, state_b, sum_tol=1e-5)
        assert_chunk_identical(runs[0][0], b, runs[0][1], state_b)


@pytest.mark.cuda
def test_chunk_kernel_rejects_bad_cluster(cuda):
    import sanafe_tpu_torch
    from sanafe_tpu_torch.compile import compile_chip

    compiled = compile_chip(*CHIPS["example"](sanafe_tpu_torch))
    prog = port_program(compiled, cuda, torch.float32, **FLAGS)
    for size in (0, 17):
        with pytest.raises(ValueError, match="cluster"):
            run_port(prog, prog.init_state(), {}, cluster=size)
