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
draws it on the host from a ``torch.Generator`` seeded by
(``SANAFE_TPU_NEUROFEM_SEED``, default 42; the timestep), and copies the
draws to the chip's device. So runs are bit-reproducible, the same on the
CPU and the card, and resumable (sample t is the same whether reached in
one sim() call or several). Neither stream is the other's: the
distribution, not the sequence, matches the reference. With every
``sigma_v`` zero (the default) nothing is drawn.
"""

from __future__ import annotations

import os

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
    """The generator seed of timestep ``t``: splitmix64 of
    ``seed * golden-ratio + t``, cut to the 32 bits torch's CPU generator
    (mt19937) keeps of a seed."""
    z = (seed * 0x9E3779B97F4A7C15 + t) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def standard_normal(t: int, shape, dtype: torch.dtype) -> torch.Tensor:
    """The ``N(0,1)`` draws of timestep ``t`` on the host, from a generator
    seeded by ``step_seed(SANAFE_TPU_NEUROFEM_SEED (default 42), t)``."""
    seed = int(os.environ.get("SANAFE_TPU_NEUROFEM_SEED", "42"))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(step_seed(seed, int(t)))
    return torch.randn(shape, generator=gen, dtype=dtype)


def neurofem_update(params, state, valid, current, t, comp):
    """process_fem (plugins/neurofem.cpp:275-318) with compartment inputs
    comp[:, 0] -> u1 and comp[:, 1] -> u2."""
    dt = params["dt"]
    lambda_d = params["lambda_d"]
    lambda_v = params["lambda_v"]

    u1 = state["u1"]
    u2 = state["u2"]
    v = state["potential"]
    u_integrated = state["u_integrated"]

    comp0 = comp[:, 0]
    comp1 = comp[:, 1]

    u1 = u1 - lambda_d * dt * u1 + comp0
    u2 = u2 - lambda_d * dt * u2 + lambda_d * comp1

    u_error = u1 + params["bias"]
    u_integrated = u_integrated + dt * u_error

    v = v - lambda_v * dt * v
    # plugins/neurofem.cpp:296-303; the draw is skipped (and no tensor
    # reaches the device) while every sigma_v is zero
    sigma_v = params["sigma_v"]
    if bool(torch.any(sigma_v != 0.0)):
        noise = standard_normal(t, v.shape, v.dtype).to(v.device)
        noise_term = sigma_v * noise
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
)
