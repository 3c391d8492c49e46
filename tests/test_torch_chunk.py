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
the same bars; they skip where there is no card. JAX is imported inside the
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


def run_port(prog, state, feeds, t0=T0, n_steps=T):
    """One chunk through the port's wrapper on the program's device."""
    plan = port_chunk.plan_chunk(prog)
    mats = port_chunk.chunk_tensors(plan, prog.device)
    rows = port_chunk.state_rows(plan, state, prog.dtype)
    spike_plane, add_plane = port_chunk.build_planes(
        prog, plan, n_steps, t0, feeds
    )
    rows_out, packed = port_chunk.chunk_kernel(
        plan, mats, rows, t0, n_steps, spike_plane, add_plane
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


def assert_chunk_match(a, b, state_a, state_b):
    np.testing.assert_array_equal(a["counter_sums"], b["counter_sums"])
    np.testing.assert_array_equal(a["masks_packed"], b["masks_packed"])
    np.testing.assert_array_equal(a["spike_log_packed"],
                                  b["spike_log_packed"])
    for i, ref in enumerate(a["energy_sums"]):
        assert abs(ref - b["energy_sums"][i]) <= 1e-6 * max(abs(ref), 1e-30)
    ref = a["sim_time_sum"]
    assert abs(ref - b["sim_time_sum"]) <= 1e-6 * max(abs(ref), 1e-30)
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
