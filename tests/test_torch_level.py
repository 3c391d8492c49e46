"""``level_plain`` (``sanafe_tpu_torch/ops/level_scan.py``), the plain
version that the level kernel (``csrc/level_kernel.cu``) is held to bit for
bit on the card, against sanafe_tpu's own per-level recurrence: a
``jax.lax.scan`` of ``sanafe_tpu/ops/step.py:_lif_update`` with the body of
``sanafe_tpu/ops/dag_chunk.py:373-386``.

Both run seeded random float32 LIF levels built with numpy: every reset and
reverse-reset mode, refractory delays up to 4, forced updates, leaks,
biases, a non-zero start state (some lanes in refractory), currents off the
1/64 grid, with and without the noise plane. sanafe_tpu replays LIF noise
from a per-lane stream (``lif_noise_values`` indexed by the step); the test
lays the plane out as that stream, so both add the same value at each step.

Bars (the ROADMAP parity contract): fired, updated and the final
refractory count exact; v and u after every step and at the end within
1e-6 * max(1, |v|) in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanafe_tpu.ops.step import _lif_update
from sanafe_tpu_torch.ops.level_scan import PARAM_KEYS, level_plain

SIZE = 257  # a ragged warp on the card
V_TOL = 1e-6


class _Prog:
    """What ``_lif_update`` reads of a device program: its dtype."""

    dtype = jnp.float32


def _level(steps: int, t0: int, noise: bool, seed: int):
    """Numpy arrays of one level: the parameter vectors, the state before
    the chunk and the ``[steps, SIZE]`` input planes (``add`` or None)."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    normal = lambda *shape: f32(rng.standard_normal(shape))  # noqa: E731
    params = {
        "bias": normal(SIZE) * (rng.random(SIZE) < 0.5),
        "leak_decay": f32(rng.random(SIZE)),
        "input_decay": f32(rng.random(SIZE)),
        "threshold": np.abs(normal(SIZE)) + f32(0.5),
        "reverse_threshold": -np.abs(normal(SIZE)) - f32(0.5),
        "reset": normal(SIZE) * f32(0.1),
        "reverse_reset": -np.abs(normal(SIZE)) * f32(0.1),
        "refractory_delay": rng.integers(0, 5, SIZE).astype(np.int32),
        # every reset mode (none, soft, hard) and every reverse mode (none,
        # soft, hard, saturate), in every pairing
        "reset_mode": (np.arange(SIZE) % 3).astype(np.int32),
        "reverse_reset_mode": (np.arange(SIZE) // 3 % 4).astype(np.int32),
        "force_update": rng.random(SIZE) < 0.3,
    }
    state = (normal(SIZE), normal(SIZE) * f32(0.1),
             rng.integers(0, 3, SIZE).astype(np.int32))
    cur = normal(steps, SIZE)
    valid = rng.random((steps, SIZE)) < 0.4
    add = normal(steps, SIZE) * f32(0.05) if noise else None
    return params, state, cur, valid, add


def _jax_level(params, state, cur, valid, add, t0):
    """sanafe_tpu's recurrence of one level (dag_chunk.py:373-386)."""
    steps = cur.shape[0]
    la = {key: jnp.asarray(value) for key, value in params.items()}
    if add is not None:
        # the noise stream: lane i's value of step t at (t - 1) * SIZE + i
        stream = np.zeros(((t0 - 1 + steps) * SIZE,), dtype=np.float32)
        stream[(t0 - 1) * SIZE:] = add.reshape(-1)
        la.update(
            lif_noise_values=jnp.asarray(stream),
            lif_noise_stride=jnp.int32(SIZE),
            lif_noise_rank=jnp.arange(SIZE, dtype=jnp.int32),
            lif_noise_len=jnp.full(SIZE, stream.size, dtype=jnp.int32),
            lif_noise_start=jnp.zeros(SIZE, dtype=jnp.int32),
        )
    ts = jnp.arange(t0, t0 + steps, dtype=jnp.int32)

    def body(carry, xs):
        v, u, refr = carry
        t, valid_t, current = xs
        st = {"potential": v, "input_current": u, "refractory": refr}
        v2, u2, r2, upd, fired = _lif_update(_Prog, la, st, valid_t,
                                             current, t)
        return (v2, u2, r2), (fired, upd, v2, u2)

    (v, u, r), (fired, upd, v_seq, u_seq) = jax.lax.scan(
        body, tuple(jnp.asarray(x) for x in state),
        (ts, jnp.asarray(valid), jnp.asarray(cur)))
    return [np.asarray(x) for x in (fired, upd, v_seq, u_seq, v, u, r)]


def _assert_close(x, y, what):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    assert x.shape == y.shape, what
    assert np.all(np.abs(x - y) <= V_TOL * np.maximum(1.0, np.abs(x))), what


@pytest.mark.parametrize("noise", [True, False], ids=["noise", "no_noise"])
@pytest.mark.parametrize("t0", [1, 40])
@pytest.mark.parametrize("steps", [1, 37, 200])
def test_level_plain_matches_sanafe_tpu_scan(steps, t0, noise):
    """level_plain against sanafe_tpu's lax.scan of _lif_update on the same
    seeded level (module docstring for the bars)."""
    params, state, cur, valid, add = _level(steps, t0, noise,
                                            seed=steps * 100 + t0)
    want = _jax_level(params, state, cur, valid, add, t0)
    tp = {key: torch.from_numpy(np.ascontiguousarray(params[key]))
          for key in PARAM_KEYS}
    got = level_plain(tp, *(torch.from_numpy(x) for x in state),
                      torch.from_numpy(cur), torch.from_numpy(valid),
                      None if add is None else torch.from_numpy(add), t0,
                      record_v=True, record_u=True)
    fired, upd, v_seq, u_seq, v, u, r = want
    assert np.array_equal(got.fired.numpy(), fired)
    assert np.array_equal(got.updated.numpy(), upd)
    assert np.array_equal(got.refractory.numpy(), r)
    _assert_close(v_seq, got.v_seq.numpy(), "v after every step")
    _assert_close(u_seq, got.u_seq.numpy(), "u after every step")
    _assert_close(v, got.v.numpy(), "v at the end")
    _assert_close(u, got.u.numpy(), "u at the end")
    # the level is not idle: lanes fire, and the modes' paths run
    if steps > 1:
        assert fired.any() and not fired.all()
        assert (r > 0).any()
