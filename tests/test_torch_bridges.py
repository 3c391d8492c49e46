"""The port's Lava and Fugu bridges (copies of sanafe_tpu's lava.py and
fugu.py) against the stub framework objects of ``tests/test_bridges.py``
(neither lava-nc nor fugu is installed), simulated with ``device="cpu"``;
the converted networks equal sanafe_tpu's."""

import importlib

import pytest

import sanafe_tpu_torch as st

from test_bridges import _Scaffold, _install_fugu_stub, _install_lava_stub


def test_lava_process_to_network(monkeypatch):
    AbstractProcess = _install_lava_stub(monkeypatch)
    from sanafe_tpu import lava as jax_bridge
    from sanafe_tpu_torch import lava as lava_bridge

    processes = [
        AbstractProcess(shape=(4,), vth=1.0, dv=0.1, du=0.2, bias_mant=0.5),
        AbstractProcess(shape=(2,), vth=2.0, dv=0.0, du=0.0),
    ]
    arch, net = lava_bridge.process_to_network(processes)
    assert isinstance(net, st.SpikingNetwork)
    assert sorted(net.groups) == ["layer0", "layer1"]
    assert len(net.groups["layer0"].neurons) == 4
    assert len(net.groups["layer1"].neurons) == 2
    attrs = net.groups["layer0"].default_neuron_config.model_attributes
    assert attrs["threshold"].as_float() == 1.0
    # Lava decays are fraction-lost; ours multiply what remains
    assert attrs["leak_decay"].as_float() == pytest.approx(0.9)
    assert attrs["input_decay"].as_float() == pytest.approx(0.8)
    edges = sum(
        len(n.edges_out) for g in net.groups.values() for n in g.neurons
    )
    assert edges == 8
    chip = st.SpikingChip(arch, device="cpu")
    chip.load(net)
    result = chip.sim(10, heartbeat=0)
    assert result["neurons_fired"] > 0  # bias drives layer0 over threshold

    jarch, jnet = jax_bridge.process_to_network(processes)
    import sanafe_tpu as sf

    jchip = sf.SpikingChip(jarch)
    jchip.load(jnet)
    ref = jchip.sim(10, heartbeat=0)
    for key in ("spikes", "neurons_fired", "neurons_updated",
                "packets_sent", "sim_time"):
        assert result[key] == ref[key], key


def test_fugu_backend_runs_scaffold(monkeypatch):
    _install_fugu_stub(monkeypatch)
    import sanafe_tpu_torch.fugu as fugu_bridge

    fugu_bridge = importlib.reload(fugu_bridge)
    assert fugu_bridge.HAVE_FUGU

    backend = fugu_bridge.sanafe_Backend(device="cpu")
    backend.compile(_Scaffold())
    assert sorted(backend.net.groups) == ["input_brick", "relay_brick"]
    spikes = backend.run(6)
    # i0 spikes at fugu times 0 and 2; relay r0 fires one step later
    by_neuron = {
        number: sorted(rows["time"])
        for number, rows in spikes.groupby("neuron_number")
    }
    assert by_neuron[0] == [0.0, 2.0]
    assert by_neuron[1] == [1.0, 3.0]
    assert 2 not in by_neuron  # r1's threshold is never reached
    spikes, potentials = backend.run(6, return_potentials=True)
    assert len(potentials) == 6
    # the backend simulates on the card unless asked otherwise
    assert fugu_bridge.sanafe_Backend().device == "cuda"
    # restore the non-stubbed module state for other tests
    monkeypatch.undo()
    importlib.reload(fugu_bridge)
    assert not fugu_bridge.HAVE_FUGU
