"""NeuroFEM combined dendrite+soma model (Python plugin), on PyTorch.

Counterpart of ``sanafe_tpu/models/neurofem.py``, itself a port of the
reference's second example plugin (``plugins/neurofem.cpp:23-320``): a
Loihi-2-style PID/FEM placeholder with two double-buffered dendritic
compartments (edges route via a ``compartment`` attribute, 0 or 1).
Compartment sums arrive one step after the presynaptic spike, matching the
reference's next_* accumulators.

The reference adds ``sigma_v * N(0,1)`` membrane noise drawn from an
``std::mt19937`` seeded by ``std::random_device``
(plugins/neurofem.cpp:26-28) — nondeterministic across runs even there.
sanafe_tpu draws it from a threefry key folded with the timestep; this port
draws it on the host, each neuron's draw a function of
(``SANAFE_TPU_NEUROFEM_SEED``, default 42; the timestep; the neuron's
index) alone: a chunk's draws at once, as the model's chunk feed
(``neurofem_noise``), copied to the chip's device once a chunk; the update
adds its step's row. So runs are bit-reproducible, the same on the CPU and
the card and with the step captured in a CUDA graph, resumable (sample t is
the same whether reached in one sim() call or several) and the same when
``sim(mesh=...)`` shards the neurons (each rank draws its own neurons').
Neither stream is the other's: the distribution, not the sequence,
matches the reference. With every ``sigma_v`` zero (the default) nothing
is drawn.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import register_soma_model

NEUROFEM_ATTRIBUTES = {
    "lambda_v": "(float) Membrane potential leak rate.",
    "lambda_d": "(float) Dendritic current leak rate.",
    "sigma_v": "(float) Gaussian membrane-noise amplitude (seeded "
    "stream; see module docstring).",
    "ki": "(float) PID integral gain.",
    "kp": "(float) PID proportional gain.",
    "bias": "(float) Constant input error bias.",
    "threshold": "(float) Firing threshold.",
    "reset": "(float) Reset potential.",
    "dt": "(float) Integration timestep.",
    "compartment": "(int, per edge) Destination compartment, 0 or 1.",
}


_MASK64 = (1 << 64) - 1


def step_seed(seed: int, t: int) -> int:
    """The seed of timestep ``t``'s draws: splitmix64 of
    ``seed * golden-ratio + t``, cut to 32 bits."""
    z = (seed * 0x9E3779B97F4A7C15 + t) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's output function on uint64 lanes (wrapping)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def standard_normal(steps: range, lanes: range) -> np.ndarray:
    """The float64 ``N(0,1)`` draws ``[len(steps), len(lanes)]`` of the
    timesteps ``steps`` for the neurons ``lanes``: neuron i's draw at step
    t is Box-Muller of two uniforms hashed from
    (``step_seed(SANAFE_TPU_NEUROFEM_SEED (default 42), t)``, i) alone."""
    seed = int(os.environ.get("SANAFE_TPU_NEUROFEM_SEED", "42"))
    seeds = np.array([step_seed(seed, t) for t in steps], dtype=np.uint64)
    # 32 bits of step seed above 31 bits of neuron index, times 2
    key = (np.arange(lanes.start, lanes.stop, dtype=np.uint64)[None, :]
           + (seeds[:, None] << np.uint64(31))) << np.uint64(1)
    golden = np.uint64(0x9E3779B97F4A7C15)
    bits1 = _mix64(key * golden) >> np.uint64(11)
    bits2 = _mix64((key | np.uint64(1)) * golden) >> np.uint64(11)
    u1 = (bits1.astype(np.float64) + 1.0) * 2.0 ** -53  # (0, 1]
    u2 = bits2.astype(np.float64) * 2.0 ** -53  # [0, 1)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * math.pi * u2)


def neurofem_noise(params, t0: int, length: int, lanes: range):
    """The model's chunk feed: the ``[length, len(lanes)]`` draws of the
    steps ``t0 .. t0 + length - 1`` (``standard_normal``), or None while
    every ``sigma_v`` is zero (nothing is drawn and no tensor reaches the
    device). Reads ``sigma_v`` back once a chunk."""
    if not bool(torch.any(params["sigma_v"] != 0.0)):
        return None
    return standard_normal(range(t0, t0 + length), lanes)


def neurofem_update(params, state, valid, current, t, comp, feed=None):
    """process_fem (plugins/neurofem.cpp:275-318) with compartment inputs
    comp[..., 0] -> u1 and comp[..., 1] -> u2. The tensors are ``[n]``,
    or ``[B, n]`` for a sweep's B samples; ``feed``, the step's ``[n]``
    noise draws (``neurofem_noise``; None: no noise), is shared by the
    samples (sanafe_tpu's ``vmap`` shares its key)."""
    dt = params["dt"]
    lambda_d = params["lambda_d"]
    lambda_v = params["lambda_v"]

    u1 = state["u1"]
    u2 = state["u2"]
    v = state["potential"]
    u_integrated = state["u_integrated"]

    comp0 = comp[..., 0]
    comp1 = comp[..., 1]

    u1 = u1 - lambda_d * dt * u1 + comp0
    u2 = u2 - lambda_d * dt * u2 + lambda_d * comp1

    u_error = u1 + params["bias"]
    u_integrated = u_integrated + dt * u_error

    v = v - lambda_v * dt * v
    # plugins/neurofem.cpp:296-303
    if feed is not None:
        noise_term = params["sigma_v"] * feed
    else:
        noise_term = torch.zeros_like(v)
    v = (
        v
        + dt * params["kp"] * u_error
        + dt * params["ki"] * u_integrated
        + dt * u2
        + noise_term
        - comp1
    )

    fired = v > params["threshold"]
    v = torch.where(fired, params["reset"], v)
    updated = torch.ones_like(fired)
    new_state = {
        "potential": v,
        "u1": u1,
        "u2": u2,
        "u_integrated": u_integrated,
    }
    return new_state, fired, updated, v


register_soma_model(
    "neurofem",
    neurofem_update,
    params={
        "lambda_v": 0.0,
        "lambda_d": 0.0,
        "sigma_v": 0.0,
        "ki": 0.0,
        "kp": 0.0,
        "bias": 0.0,
        "threshold": 0.0,
        "reset": 0.0,
        "dt": 1.0e-3,
    },
    state={"potential": 0.0, "u1": 0.0, "u2": 0.0, "u_integrated": 0.0},
    attributes=NEUROFEM_ATTRIBUTES,
    dendrite_compartments=2,
    feed=neurofem_noise,
)
