"""The port's ParameterSweep (sanafe_tpu_torch/batch.py) against sanafe_tpu's.

Both packages build the same chips from one recipe (``batch_chip``, the
chip of ``tests/test_batch.py:_build`` with the same seed) and sweep them
with one override dict in sanafe_tpu's names and layouts:

- a threshold sweep in float64 (three samples): counters equal, energies and
  ``sim_time`` within 1e-12 relative (the bar of ``tests/test_batch.py``),
  and the same against three sequential ``sim()`` calls of the port;
- a cost-column sweep in float32 (fusion off) and a dynamics-only float32
  sweep (the fused roll-up kept): counters equal, energies within 1e-6;
- a conv-filter sweep, its HWIO override carried to the port's OIHW by
  ``ops/conv.py:hwio_to_oihw``; a delay-dendrite chip (scatter delivery);
- a kernel-delivery program (``use_kernel=True`` on the CPU: packed arrival
  planes through ``delivery_batch_plain``), also with ``block_weights`` and
  ``block_counts`` swept per sample;
- ``delivery_batch_plain`` against ``delivery_packed_plain`` sample by
  sample, ``expand_group_values`` and the error cases;
- plugin somas: a threshold and a stimulation-current sweep of the
  Hodgkin-Huxley chip (shared unit state) against sanafe_tpu's, also
  through the kernel path, and each sample against a single chip; a
  NeuroFEM threshold sweep (the batched compartment scatter) against
  sanafe_tpu's without noise, and with noise each sample against the
  port's single chip (the step's draws are shared by the samples).

On the CPU the batched delivery kernel's wrapper takes its plain version;
``tests/test_torch_cuda.py`` holds the CUDA kernel to it on the card.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import sanafe_tpu as sf
import sanafe_tpu_torch as st
from sanafe_tpu.batch import ParameterSweep as JaxSweep
from sanafe_tpu.batch import expand_group_values as jax_expand
from sanafe_tpu_torch import batch as port_batch
from sanafe_tpu_torch.ops import step as port_step
from sanafe_tpu_torch.ops.conv import hwio_to_oihw
from sanafe_tpu_torch.ops.delivery import (
    build_live_rows,
    delivery_batch_kernel,
    delivery_batch_plain,
    delivery_packed_plain,
    pack_arrival_plane,
)

from test_torch_chips import (  # noqa: F401 (a fixture)
    batch_chip,
    conv_chip,
    delay_chip,
    hh_chip,
    low_bulk_threshold,
    random_chip,
)

COUNTERS = ("spikes", "neurons_fired", "neurons_updated", "packets_sent")


def _chips(builder, dtype=torch.float64, **kwargs):
    """The same chip loaded in sanafe_tpu and in the port (on the CPU)."""
    arch, net = builder(sf, **kwargs)
    jchip = sf.SpikingChip(arch)
    jchip.load(net)
    arch, net = builder(st, **kwargs)
    pchip = st.SpikingChip(arch, device="cpu", dtype=dtype)
    pchip.load(net)
    return jchip, pchip


@pytest.fixture()
def float32_jax():
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def assert_same(jout, pout, rel):
    for key in COUNTERS:
        np.testing.assert_array_equal(np.asarray(jout[key]),
                                      np.asarray(pout[key]), err_msg=key)
    for key in jout["energy"]:
        np.testing.assert_allclose(pout["energy"][key], jout["energy"][key],
                                   rtol=rel, atol=0, err_msg=key)
    np.testing.assert_allclose(pout["sim_time"], jout["sim_time"], rtol=rel,
                               atol=0)


THRESHOLDS = np.array([1.5, 2.0, 4.0])


def test_expand_group_values_matches_jax():
    jchip, pchip = _chips(batch_chip)
    for name, groups in (
        ("threshold", {"a": THRESHOLDS}),
        ("bias", {"b": np.array([5.0, 6.0])}),
        ("leak_decay", {"a": np.linspace(0.5, 0.9, 24)[None].repeat(2, 0),
                        "b": np.array([0.1, 0.2])}),
    ):
        np.testing.assert_array_equal(
            st.expand_group_values(pchip.compiled, name, groups),
            jax_expand(jchip.compiled, name, groups))
    with pytest.raises(ValueError):
        st.expand_group_values(pchip.compiled, "bias", {})
    with pytest.raises(ValueError):
        st.expand_group_values(pchip.compiled, "bias",
                               {"a": np.zeros((2, 3))})
    with pytest.raises(ValueError):
        st.expand_group_values(pchip.compiled, "bias",
                               {"a": np.zeros(2), "b": np.zeros(3)})


def test_threshold_sweep_float64_matches_jax_and_sequential():
    jchip, pchip = _chips(batch_chip)
    over = jax_expand(jchip.compiled, "threshold", {"a": THRESHOLDS})
    jout = JaxSweep(jchip, {"threshold": over}).run(40, chunk=16)
    sweep = st.ParameterSweep(pchip, {"threshold": over})
    assert sweep.prog.dtype == torch.float64 and sweep.batch == 3
    pout = sweep.run(40, chunk=16)
    assert pout["timesteps_executed"] == 40
    assert_same(jout, pout, 1e-12)
    assert len(set(pout["spikes"].tolist())) > 1
    for i, th in enumerate(THRESHOLDS):
        arch, net = batch_chip(st, threshold=float(th))
        chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
        chip.load(net)
        r = chip.sim(40, timing_model="simple", heartbeat=0)
        for key in COUNTERS:
            assert pout[key][i] == r[key], (th, key)
        for key, value in r["energy"].items():
            assert pout["energy"][key][i] == pytest.approx(value, rel=1e-12)
        assert pout["sim_time"][i] == pytest.approx(r["sim_time"], rel=1e-12)


def test_cost_column_sweep_float32_matches_jax(float32_jax):
    jchip, pchip = _chips(batch_chip, dtype=torch.float32)
    base = np.asarray(jchip.compiled.soma_energy_update)
    over = base[None, :] * np.array([1.0, 4.0, 10.0])[:, None]
    jout = JaxSweep(jchip, {"soma_energy_update": over}).run(20)
    sweep = st.ParameterSweep(pchip, {"soma_energy_update": over})
    assert not sweep.prog.fused_rollup  # a baked cost column: fusion off
    pout = sweep.run(20)
    assert_same(jout, pout, 1e-6)
    soma = pout["energy"]["soma"]
    assert soma[0] < soma[1] < soma[2]


def test_dynamics_sweep_float32_keeps_fusion_and_matches_jax(float32_jax):
    jchip, pchip = _chips(batch_chip, dtype=torch.float32)
    over = jax_expand(jchip.compiled, "threshold",
                      {"a": np.array([1.5, 4.0])})
    jsweep = JaxSweep(jchip, {"threshold": over})
    sweep = st.ParameterSweep(pchip, {"threshold": over})
    assert jsweep.prog.fused_rollup and sweep.prog.fused_rollup
    assert sweep.prog.dense_delivery == jsweep.prog.dense_delivery
    assert_same(jsweep.run(25), sweep.run(25), 1e-6)


def test_dynamics_sweep_float32_deferred_rollup(float32_jax):
    """Fused roll-up without dense delivery: the sweep emits the fired
    planes and runs one batched roll-up a chunk, as the scan does."""
    jchip, pchip = _chips(random_chip, dtype=torch.float32, cores=16,
                          neurons_per_core=64)
    over = jax_expand(jchip.compiled, "threshold",
                      {"pop": np.array([32.0, 64.0, 200.0])})
    jsweep = JaxSweep(jchip, {"threshold": over, "bias": np.broadcast_to(
        np.asarray(jchip.compiled.bias), over.shape)})
    sweep = st.ParameterSweep(pchip, {"threshold": over, "bias":
                                      np.broadcast_to(np.asarray(
                                          pchip.compiled.bias), over.shape)})
    assert sweep.prog.fused_rollup and not sweep.prog.dense_delivery
    assert_same(jsweep.run(30, chunk=12), sweep.run(30, chunk=12), 1e-6)


def test_conv_filter_sweep_matches_jax(low_bulk_threshold):
    from sanafe_tpu.ops.step import make_device_program

    jchip, pchip = _chips(conv_chip)
    base = np.asarray(make_device_program(jchip.compiled, fuse=False)
                      .arrays["conv_kernel_0"])
    assert base.ndim == 4  # HWIO with the count channel last
    over = np.stack([base.copy() for _ in range(3)])
    for i, scale in enumerate((0.0, 1.0, 3.0)):
        over[i, ..., :-1] *= scale
    sweep = st.ParameterSweep(pchip, {"conv_kernel_0": over})
    assert sweep.prog.conv_delivery is not None
    # the port holds the same filters OIHW: the conversion carries them
    torch.testing.assert_close(
        hwio_to_oihw(torch.from_numpy(base)),
        sweep.prog.arrays["conv_kernel_0"], rtol=0, atol=0)
    torch.testing.assert_close(hwio_to_oihw(torch.from_numpy(over)),
                               sweep.arrays["conv_kernel_0"], rtol=0, atol=0)
    jout = JaxSweep(jchip, {"conv_kernel_0": over}).run(15)
    pout = sweep.run(15)
    assert_same(jout, pout, 1e-12)
    assert pout["neurons_fired"][0] < pout["neurons_fired"][2]


def test_delay_dendrite_sweep_matches_jax():
    jchip, pchip = _chips(delay_chip)
    assert pchip.compiled.has_delay_dendrite
    over = jax_expand(jchip.compiled, "threshold",
                      {"pop": np.array([0.5, 1.0, 1.5])})
    sweep = st.ParameterSweep(pchip, {"threshold": over})
    assert sweep.prog.block is None  # per-edge scatter delivery
    pout = sweep.run(30, chunk=8)
    assert_same(JaxSweep(jchip, {"threshold": over}).run(30, chunk=8), pout,
                1e-12)
    assert len(set(pout["spikes"].tolist())) > 1


@pytest.mark.parametrize("swept", ["threshold", "block_weights",
                                   "block_counts"])
def test_kernel_delivery_program_matches_jax(monkeypatch, swept):
    """A kernel-delivery program (packed arrival planes, batched delivery
    through ``delivery_batch_kernel``'s plain version on the CPU) against
    sanafe_tpu's sweep, with shared or per-sample blocks."""
    monkeypatch.setattr(port_batch, "make_device_program", functools.partial(
        port_step.make_device_program, use_kernel=True))
    jchip, pchip = _chips(random_chip, cores=16, neurons_per_core=64)
    over = jax_expand(jchip.compiled, "threshold",
                      {"pop": np.array([32.0, 64.0, 200.0])})
    overrides = {"threshold": over}
    jprog = JaxSweep(jchip, overrides).prog
    if swept == "block_weights":
        base = np.asarray(jprog.arrays["block_weights"])
        overrides = {swept: base[None] * np.array([-1.0, 0.25, 1.0])[
            :, None, None, None]}
    elif swept == "block_counts":
        base = np.asarray(jprog.arrays["block_counts"])
        keep = np.stack([np.arange(base.shape[1]) % k == 0
                         for k in (1, 2, 3)])
        overrides = {swept: base[None] * keep[:, None, :, None]}
    sweep = st.ParameterSweep(pchip, overrides)
    assert sweep.prog.kernel_delivery and "block_counts" not in (
        sweep.prog.arrays)
    if swept == "block_counts":
        assert sweep.arrays["block_arrivals"].shape[0] == 3
    pout = sweep.run(30)
    assert_same(JaxSweep(jchip, overrides).run(30), pout, 1e-12)
    assert len(set(pout["neurons_fired"].tolist())) > 1


def _blocks(dtype):
    from sanafe_tpu_torch.compile import compile_chip
    from sanafe_tpu_torch.ops.step import build_block_delivery

    compiled = compile_chip(*random_chip(st, cores=16, neurons_per_core=128,
                                         n_log_potential=0))
    blk = build_block_delivery(compiled, dtype, "cpu")
    return compiled.n_neurons, blk, pack_arrival_plane(blk.counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_delivery_batch_plain_matches_packed_plain(dtype):
    """Sample by sample: exact on the chip's integer weights, within 1e-12
    in float64 on seeded real weights (the products group differently);
    per-sample weights and arrival planes too."""
    n, blk, plane = _blocks(dtype)
    rng = np.random.default_rng(4)
    rates = (0.0, 0.1, 0.5, 1.0, 0.25)
    fired = np.zeros((len(rates), blk.n_pad), dtype=bool)
    for b, rate in enumerate(rates):
        fired[b, :n] = rng.random(n) < rate
    x = torch.from_numpy(fired).to(dtype).view(len(rates), blk.n_tiles,
                                              blk.tile)
    real = torch.from_numpy(rng.uniform(-1, 1, tuple(blk.weights.shape))).to(
        dtype) * (blk.counts > 0)
    keep = torch.stack([torch.arange(blk.tile) % (b + 1) == 0
                        for b in range(len(rates))])
    per_sample = torch.stack([pack_arrival_plane(
        blk.counts * keep[b][None, :, None].to(torch.int8))
        for b in range(len(rates))])
    scaled = blk.weights[None] * torch.arange(1, len(rates) + 1).to(dtype)[
        :, None, None, None]
    cases = [(blk.weights, plane, True), (scaled, per_sample, True)]
    if dtype == torch.float64:
        cases.append((real, plane, False))
    for weights, arrivals, exact in cases:
        args = (weights, arrivals, blk.src_tiles, blk.dest_offsets,
                blk.max_blocks_per_dest)
        cur, arrived = delivery_batch_plain(x, *args)
        kcur, karrived = delivery_batch_kernel(  # CPU: the plain version
            x, *args, build_live_rows(weights, arrivals))
        assert torch.equal(cur, kcur) and torch.equal(arrived, karrived)
        assert cur.shape == (len(rates), blk.n_tiles, blk.tile)
        for b in range(len(rates)):
            w_b = weights[b] if weights.dim() == 4 else weights
            a_b = arrivals[b] if arrivals.dim() == 4 else arrivals
            one_cur, one_arrived = delivery_packed_plain(
                x[b], w_b, a_b, blk.src_tiles, blk.dest_offsets,
                blk.max_blocks_per_dest)
            assert torch.equal(arrived[b], one_arrived), b
            if exact:
                assert torch.equal(cur[b], one_cur), b
            else:
                torch.testing.assert_close(cur[b], one_cur, rtol=1e-12,
                                           atol=1e-12)
        assert not arrived[0].any() and arrived[3].any()


def test_sweep_errors():
    _, pchip = _chips(batch_chip)
    n = pchip.compiled.n_neurons
    with pytest.raises(KeyError):
        st.ParameterSweep(pchip, {"nonsense": np.zeros((2, 3))})
    with pytest.raises(ValueError):
        st.ParameterSweep(pchip, {})
    with pytest.raises(ValueError):
        st.ParameterSweep(pchip, {"threshold": np.zeros((2, 5))})
    with pytest.raises(ValueError):
        st.ParameterSweep(pchip, {"threshold": np.zeros((2, n)),
                                  "bias": np.zeros((3, n))})
    # a mesh is a one-dimensional DeviceMesh (tests/test_torch_parallel.py
    # splits the samples over one)
    with pytest.raises(TypeError, match="DeviceMesh"):
        st.ParameterSweep(pchip, {"threshold": np.zeros((2, n))},
                          mesh=object())
    # host-fed noise: the LFSR and Poisson streams are drawn per chip
    from test_torch_chips import stochastic_chip, truenorth_chip

    for builder in (truenorth_chip, stochastic_chip):
        arch, net = builder(st)
        chip = st.SpikingChip(arch, device="cpu")
        chip.load(net)
        with pytest.raises(ValueError, match="stochastic"):
            st.ParameterSweep(chip, {"threshold": np.zeros(
                (2, chip.compiled.n_neurons))})
    # a plugin soma chip sweeps (the plugin sweep tests below hold it to
    # sanafe_tpu)
    arch, net = hh_chip(st)
    chip = st.SpikingChip(arch, device="cpu")
    chip.load(net)
    out = st.ParameterSweep(chip, {"threshold": np.zeros(
        (2, chip.compiled.n_neurons))}).run(5)
    assert out["neurons_updated"].tolist() == [5 * chip.compiled.n_neurons] * 2
    assert np.all(np.isfinite(out["energy"]["total"]))


# --- plugin somas -------------------------------------------------------------

def _plugin_sweep_both(builder, overrides_of, steps, **kwargs):
    """One plugin chip swept in both packages with the overrides
    ``overrides_of(compiled)`` gives: (sanafe_tpu's result, the port's)."""
    jchip, pchip = _chips(builder, **kwargs)
    overrides = overrides_of(pchip.compiled)
    pout = st.ParameterSweep(pchip, overrides).run(steps, chunk=16)
    return JaxSweep(jchip, overrides).run(steps, chunk=16), pout


def _hh_current(compiled):
    return {"plugin_hodgkin_huxley_current": jax_expand(
        compiled, "plugin_hodgkin_huxley_current",
        {"pop": np.array([-320.0, -250.0, -190.0])},
        base=compiled.plugin_params["hodgkin_huxley"]["current"])}


def test_hh_threshold_sweep_matches_jax():
    """A 3-sample threshold sweep of ``hh_chip`` (shared unit state, stride
    4): counters exact, float64 energies and sim_time within 1e-12 of
    sanafe_tpu's vmapped sweep."""
    jout, pout = _plugin_sweep_both(hh_chip, lambda c: {
        "threshold": jax_expand(c, "threshold", {"pop": THRESHOLDS})}, 60)
    assert_same(jout, pout, 1e-12)
    assert pout["spikes"].min() > 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_hh_parameter_sweep_matches_jax(monkeypatch, use_kernel):
    """A sweep of the Hodgkin-Huxley stimulation current
    (``plugin_hodgkin_huxley_current``): the samples differ and each equals
    sanafe_tpu's; with ``use_kernel=True`` the batched delivery kernel's
    path (its plain version on the CPU) delivers."""
    if use_kernel:
        monkeypatch.setattr(port_batch, "make_device_program",
                            functools.partial(port_step.make_device_program,
                                              use_kernel=True))
    jout, pout = _plugin_sweep_both(hh_chip, _hh_current, 60)
    assert_same(jout, pout, 1e-12)
    assert len(set(pout["spikes"].tolist())) == 3


def test_hh_sweep_samples_equal_single_chips():
    """Each sample of the current sweep equals a single chip whose neurons
    carry that sample's current (the initial state is the compiled chip's
    in both: the shared unit is pre-advanced with the compiled current,
    as sanafe_tpu does)."""
    arch, net = hh_chip(st)
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    chip.load(net)
    over = _hh_current(chip.compiled)
    out = st.ParameterSweep(chip, over).run(40)
    values = over["plugin_hodgkin_huxley_current"]
    for i in range(values.shape[0]):
        arch, net = hh_chip(st)
        one = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
        one.load(net)
        one.compiled.plugin_params["hodgkin_huxley"]["current"][:] = (
            values[i])
        one._invalidate_programs()
        # the sweep's initial state: pre-advanced with the compiled current
        one._device_state = port_step.initial_state(chip.compiled,
                                                    torch.float64, "cpu")
        ref = one.sim(40, timing_model="simple", heartbeat=0)
        for key in COUNTERS:
            assert int(out[key][i]) == ref[key], (i, key)
        for key in ref["energy"]:
            np.testing.assert_allclose(out["energy"][key][i],
                                       ref["energy"][key], rtol=1e-12)
        np.testing.assert_allclose(out["sim_time"][i], ref["sim_time"],
                                   rtol=1e-12)


def _fem_threshold(compiled):
    return {"plugin_neurofem_threshold": jax_expand(
        compiled, "plugin_neurofem_threshold",
        {"post": np.array([0.8, 1.5, 2.5])},
        base=compiled.plugin_params["neurofem"]["threshold"])}


def test_neurofem_sweep_matches_jax():
    """NeuroFEM (two compartments: the batched scatter path) without noise:
    a threshold sweep equals sanafe_tpu's."""
    from test_torch_chips import neurofem_chip

    jout, pout = _plugin_sweep_both(neurofem_chip, _fem_threshold, 60)
    assert_same(jout, pout, 1e-12)
    assert len(set(pout["neurons_fired"].tolist())) > 1


def test_noisy_neurofem_samples_equal_single_chips():
    """With ``sigma_v > 0`` the noise of a step is drawn once and shared by
    the samples: each sample equals the port's single chip with that
    sample's threshold (the streams differ from sanafe_tpu's)."""
    from test_torch_chips import neurofem_chip

    def noisy(mod):
        return neurofem_chip(mod, sigma_v=0.3)

    arch, net = noisy(st)
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    chip.load(net)
    over = _fem_threshold(chip.compiled)
    out = st.ParameterSweep(chip, over).run(50)
    values = over["plugin_neurofem_threshold"]
    for i in range(values.shape[0]):
        arch, net = noisy(st)
        one = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
        one.load(net)
        slots = one.compiled.groups["post"]
        for offset, neuron in enumerate(one.mapped_neuron_groups["post"]):
            neuron.set_attributes(
                {"threshold": float(values[i, slots[offset]])})
        ref = one.sim(50, timing_model="simple", heartbeat=0)
        for key in COUNTERS:
            assert int(out[key][i]) == ref[key], (i, key)
        for key in ref["energy"]:
            np.testing.assert_allclose(out["energy"][key][i],
                                       ref["energy"][key], rtol=1e-12)
    assert len(set(out["neurons_fired"].tolist())) > 1
