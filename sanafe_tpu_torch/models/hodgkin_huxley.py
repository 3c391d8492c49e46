"""Hodgkin-Huxley soma model (Python plugin), on PyTorch.

Counterpart of ``sanafe_tpu/models/hodgkin_huxley.py``, itself a port of
the reference's example dlopen plugin (``plugins/hodgkin_huxley.cpp:22-178``):
classic four-variable HH with exponential-Euler integration. The
stimulation current comes from the per-neuron ``current`` attribute (the
synaptic input is ignored, as in the reference); a spike is an upward
crossing of the +25 mV boundary, and the status is otherwise always
"updated". The reference plugin's state is per-UNIT, not per-neuron
(``shared_unit_state`` below).

The integer powers are the products JAX's ``integer_pow`` takes
(``n**4 = (n*n)*(n*n)``, ``m**3 = m*(m*m)``); the exponentials are
torch's, which may differ from XLA's in the last ulp.

A float32 chip's update is computed in float64 and its results rounded to
float32 once an application. torch's float32 ``exp`` differs between the
CPU and the card in the last bit, and the state is a long chain of
applications (a shared unit of k members applies the update k times a
step), so float32 arithmetic would let the two devices drift apart; in
float64 a last-bit difference is rounded away when the state is stored.
"""

from __future__ import annotations

import torch

from . import register_soma_model

HH_ATTRIBUTES = {
    "m": "(float) Sodium activation gating variable initial value.",
    "n": "(float) Potassium activation gating variable initial value.",
    "h": "(float) Sodium inactivation gating variable initial value.",
    "current": "(float) Stimulation current per area.",
}

# Membrane/channel constants (plugins/hodgkin_huxley.cpp:14-27)
C_M = 10.0
G_NA = 1200.0
G_K = 360.0
G_L = 3.0
V_NA = 50.0
V_K = -77.0
V_L = 54.387
DT = 0.1


def hodgkin_huxley_update(params, state, valid, current, t):
    dtype = state["V"].dtype
    wide = torch.float64
    v = state["V"].to(wide)
    m = state["m"].to(wide)
    n = state["n"].to(wide)
    h = state["h"].to(wide)
    current_in = params["current"].to(wide)

    alpha_n = (0.01 * (v + 55.0)) / (1.0 - torch.exp(-0.1 * (v + 55.0)))
    alpha_m = (0.1 * (v + 40.0)) / (1.0 - torch.exp(-0.1 * (v + 40.0)))
    alpha_h = 0.07 * torch.exp(-0.05 * (v + 65.0))

    beta_n = 0.125 * torch.exp(-0.01125 * (v + 55.0))
    beta_m = 4.0 * torch.exp(-0.05556 * (v + 65.0))
    beta_h = 1.0 / (1.0 + torch.exp(-0.1 * (v + 35.0)))

    tau_n = 1.0 / (alpha_n + beta_n)
    tau_m = 1.0 / (alpha_m + beta_m)
    tau_h = 1.0 / (alpha_h + beta_h)

    pm = alpha_m / (alpha_m + beta_m)
    pn = alpha_n / (alpha_n + beta_n)
    ph = alpha_h / (alpha_h + beta_h)

    n_sq = n * n
    n4 = n_sq * n_sq
    m3 = m * (m * m)
    denominator = G_L + G_K * n4 + G_NA * m3 * h
    tau_v = C_M / denominator
    v_inf = (
        G_L * V_L + G_K * n4 * V_K + G_NA * m3 * h * V_NA + current_in
    ) / denominator

    prev_v = state["V"]
    v = (v_inf + (v - v_inf) * torch.exp(-DT / tau_v)).to(dtype)
    m = (pm + (m - pm) * torch.exp(-DT / tau_m)).to(dtype)
    n = (pn + (n - pn) * torch.exp(-DT / tau_n)).to(dtype)
    h = (ph + (h - ph) * torch.exp(-DT / tau_h)).to(dtype)

    fired = (prev_v < 25.0) & (v > 25.0)
    updated = torch.ones_like(fired)
    new_state = {"V": v, "m": m, "n": n, "h": h}
    return new_state, fired, updated, v


register_soma_model(
    "hodgkin_huxley",
    hodgkin_huxley_update,
    params={"current": 0.0, "m": 0.0, "n": 0.0, "h": 0.0},
    state={"V": 0.0, "m": 0.0, "n": 0.0, "h": 0.0},
    attributes=HH_ATTRIBUTES,
    # The reference plugin keeps ONE V/m/n/h for the whole unit
    # (plugins/hodgkin_huxley.cpp:38-43 — neuron_address is ignored), so
    # all neurons mapped to one hh unit advance a single shared sequence.
    shared_unit_state=True,
)
