"""Plugin soma models, checkpoints and runtime attribute updates of
sanafe_tpu_torch against sanafe_tpu, on the CPU.

The same numpy-seeded inputs and builder recipes go through both packages
(``tests/test_torch_chips.py``: ``hh_chip``, four Hodgkin-Huxley units a
core sharing their state over 4 members; ``neurofem_chip``, both NeuroFEM
compartments). JAX runs in float64 (``tests/conftest.py``), the port on the
CPU in float64. Tolerances:

- update functions in float64: within 1e-12 * max(1, |x|) (XLA's ``exp``
  and torch's may round apart in the last ulp, and XLA may contract
  products into fused multiply-adds). Measured over the 10 applications
  below: 2.1e-14 (HH), 0 (NeuroFEM).
- chips through ``SpikingChip.sim``: spike rasters, counters and the
  detailed ``sim_time`` identical, energies within 1e-12 relative;
  potentials within 1e-12 * max(1, |v|) for NeuroFEM and the user model,
  and 1e-10 * max(1, |v|) for Hodgkin-Huxley, whose trajectory through a
  spike amplifies a last-ulp ``exp`` difference over 480 applications
  (measured 1.5e-12 on ``hh_chip`` after 120 steps; NeuroFEM 1.5e-15, the
  user model 0).
- the cfg5_hh golden of the reference binary: byte for byte.
- NeuroFEM noise (``sigma_v > 0``): the port draws its own stream
  (``models/neurofem.py``), so it is held to the distribution: sample mean
  within 4 standard errors of 0 and standard deviation within 5% of
  sigma_v; a run split over two ``sim()`` calls equals one run bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanafe_tpu as sf
import sanafe_tpu_torch as st

from test_torch_chips import (
    PLUGIN_CHIPS,
    compile_both,
    example_chip,
    neurofem_chip,
    random_chip,
    summary_without_volatile,
    truenorth_chip,
)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden_ref"
FIXTURES = GOLDEN / "fixtures"
STEPS = 120
F64_REL = 1e-12
V_BAR = {"hh": 1e-10, "neurofem": 1e-12, "user": 1e-12}
TRACES = ("spikes", "potentials", "perf", "messages")


@pytest.fixture(autouse=True)
def f64(monkeypatch):
    """sanafe_tpu's float64 lane (conftest.py turns x64 on); the step scan
    on the CPU, no Pallas kernel."""
    monkeypatch.delenv("SANAFE_PALLAS_CHUNK", raising=False)
    monkeypatch.delenv("SANAFE_TPU_NEUROFEM_SEED", raising=False)
    assert jax.config.jax_enable_x64


def loaded(mod, builder, **kw):
    arch, net = builder(mod)
    if mod is st:
        kw = {"device": "cpu", "dtype": torch.float64, **kw}
    chip = mod.SpikingChip(arch, **kw)
    chip.load(net)
    return chip


def raster(result):
    return [[(n.group_name, n.neuron_offset) for n in step]
            for step in result["spike_trace"].data]


def assert_v(a, b, rel, what):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    err = np.abs(a - b) / np.maximum(1.0, np.abs(a))
    assert np.all(err <= rel), (what, float(err.max()))


def assert_results_match(a, b, v_rel):
    """Port result ``b`` against sanafe_tpu's ``a``."""
    for key in ("spikes", "neurons_fired", "neurons_updated", "packets_sent",
                "sim_time"):
        assert a[key] == b[key], key
    for key, ref in a["energy"].items():
        assert abs(ref - b["energy"][key]) <= F64_REL * max(abs(ref), 1e-30)
    assert raster(a) == raster(b)
    assert_v(a["potential_trace"].data, b["potential_trace"].data, v_rel,
             "potentials")


# --- the update functions ----------------------------------------------------

def _update_inputs(name, n=64, seed=3):
    rng = np.random.default_rng(seed)
    if name == "hodgkin_huxley":
        params = {"current": rng.uniform(0.0, 400.0, n),
                  "m": np.zeros(n), "n": np.zeros(n), "h": np.zeros(n)}
        state = {"V": rng.uniform(-80.0, 30.0, n),
                 "m": rng.uniform(0.0, 1.0, n),
                 "n": rng.uniform(0.0, 1.0, n),
                 "h": rng.uniform(0.0, 1.0, n)}
    else:
        params = {"lambda_v": rng.uniform(0.0, 0.5, n),
                  "lambda_d": rng.uniform(0.0, 0.5, n),
                  "sigma_v": np.zeros(n), "ki": rng.uniform(0.0, 1.0, n),
                  "kp": rng.uniform(0.0, 3.0, n),
                  "bias": rng.uniform(-0.2, 0.2, n),
                  "threshold": rng.uniform(0.5, 2.0, n),
                  "reset": np.zeros(n), "dt": np.full(n, 0.05)}
        state = {"potential": rng.uniform(-1.0, 1.0, n),
                 "u1": rng.uniform(-1.0, 1.0, n),
                 "u2": rng.uniform(-1.0, 1.0, n),
                 "u_integrated": rng.uniform(-1.0, 1.0, n)}
    valid = rng.random(n) < 0.5
    current = rng.uniform(-1.0, 1.0, n)
    comp = rng.uniform(-0.5, 1.0, (n, 2))
    return params, state, valid, current, comp


@pytest.mark.parametrize("name", ["hodgkin_huxley", "neurofem"])
def test_update_matches_jax(name):
    """Ten applications of each built-in plugin update from the same
    numpy-seeded inputs: fired and updated identical, the state and the
    potential within 1e-12 * max(1, |x|)."""
    from sanafe_tpu.models import get_model as jax_model

    from sanafe_tpu_torch.models import get_model as port_model

    params, state, valid, current, comp = _update_inputs(name)
    jspec, pspec = jax_model(name), port_model(name)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ps = {k: torch.from_numpy(v) for k, v in state.items()}
    extra_j = (jnp.asarray(comp),) if jspec.dendrite_compartments else ()
    extra_p = (torch.from_numpy(comp),) if pspec.dendrite_compartments else ()
    fired_any = False
    for t in range(1, 11):
        js, jf, ju, jv = jspec.soma_update(
            jp, js, jnp.asarray(valid), jnp.asarray(current), t, *extra_j)
        ps, pf, pu, pv = pspec.soma_update(
            pp, ps, torch.from_numpy(valid), torch.from_numpy(current), t,
            *extra_p)
        np.testing.assert_array_equal(np.asarray(jf), pf.numpy())
        np.testing.assert_array_equal(np.asarray(ju), pu.numpy())
        fired_any |= bool(pf.any())
        assert pv.dtype == torch.float64
        for key, a, b in [("potential", jv, pv)] + [
                (k, js[k], ps[k]) for k in js]:
            assert_v(a, b, F64_REL, key)
    assert fired_any


def test_registry_matches_jax():
    """The built-in plugin specs agree with sanafe_tpu's; a new name takes
    the next plugin id, and registering it again keeps its id."""
    from sanafe_tpu import models as jax_models

    from sanafe_tpu_torch import models as port_models

    for name in ("hodgkin_huxley", "neurofem"):
        a, b = jax_models.get_model(name), port_models.get_model(name)
        for field in ("soma_model_id", "dendrite_model_id", "param_defaults",
                      "state_init", "dendrite_compartments",
                      "shared_unit_state", "attributes", "implements_soma",
                      "implements_dendrite"):
            assert getattr(a, field) == getattr(b, field), (name, field)
        assert b.soma_model_id >= port_models.SOMA_MODEL_PLUGIN_BASE
    assert set(st.get_builtin_models()) >= {
        "hodgkin_huxley", "neurofem", "leaky_integrate_fire", "truenorth"}
    first = port_models.register_soma_model(
        "registry_probe_a", lambda *a: None, params={"x": 1.0})
    again = port_models.register_soma_model(
        "registry_probe_a", lambda *a: None, params={"x": 2.0})
    other = port_models.register_soma_model("registry_probe_b",
                                            lambda *a: None)
    assert again.soma_model_id == first.soma_model_id
    assert other.soma_model_id == first.soma_model_id + 1
    assert port_models.get_model("registry_probe_a").param_defaults == {
        "x": 2.0}


@pytest.mark.parametrize("name", sorted(PLUGIN_CHIPS))
def test_plugin_compile_matches_jax(name):
    """The plugin fields of the compiled chip (test_compiled_chip_matches_jax
    compares the numpy fields): specs, per-neuron parameters, the shared
    stride and the compartment count."""
    a, b = compile_both(name)
    assert [(s.name, s.soma_model_id) for s in a.plugin_specs] == [
        (s.name, s.soma_model_id) for s in b.plugin_specs]
    assert a.plugin_params.keys() == b.plugin_params.keys()
    for spec, params in a.plugin_params.items():
        assert params.keys() == b.plugin_params[spec].keys()
        for key, values in params.items():
            np.testing.assert_array_equal(values, b.plugin_params[spec][key])
    for field in ("plugin_shared_max_stride", "has_plugin_comp",
                  "max_plugin_comp"):
        assert getattr(a, field) == getattr(b, field), field
    if name == "hh":
        assert b.plugin_shared_max_stride == 4
    else:
        assert b.max_plugin_comp == 2 and b.has_plugin_comp
        comp_edges = b.edge_tap[b.dendrite_model[b.edge_dest_slot] == 3]
        assert set(comp_edges.tolist()) == {0, 1}


# --- chips through SpikingChip ----------------------------------------------

@pytest.mark.parametrize("name", sorted(PLUGIN_CHIPS))
def test_plugin_chip_matches_jax(name):
    """A plugin chip through both packages' SpikingChip: detailed timing,
    spike and potential traces, two sim() calls."""
    runs = []
    for mod in (sf, st):
        chip = loaded(mod, PLUGIN_CHIPS[name])
        first = chip.sim(STEPS // 2, heartbeat=0, spike_trace=True,
                         potential_trace=True)
        second = chip.sim(STEPS // 2, heartbeat=0, spike_trace=True,
                          potential_trace=True)
        runs.append((first, second))
    for a, b in zip(*runs):
        assert b["device_engine"] == "scan"
        assert a["neurons_fired"] > 0
        assert_results_match(a, b, V_BAR[name])


def _reference_golden(name, summary, out, traces=TRACES):
    """The trace files under ``out`` and the run summary against the
    reference binary's golden ``name`` (the summary without its build id
    and wall times)."""
    for trace in traces:
        golden = (GOLDEN / name / f"{trace}.csv").read_text()
        assert (out / f"{trace}.csv").read_text() == golden, trace
    golden = (GOLDEN / name / "run_summary.yaml").read_text()
    assert summary_without_volatile(summary) == (
        summary_without_volatile(golden))


@pytest.mark.parametrize("device_sweep", [False, True],
                         ids=["host_sweep", "device_sweep"])
def test_reference_golden_hh(device_sweep, tmp_path, monkeypatch):
    """The reference binary's cfg5_hh (arch_hh.yaml + snn_hh.net, three HH
    neurons on one shared unit, 100 detailed steps) byte for byte through
    the port's API in float64 on the CPU. The arch names the reference's
    hodgkin_huxley.so; the registered name resolves first, so it is never
    loaded. The device-sweep run takes its sim_time from the merge sweep
    and leaves the message trace to the host sweep."""
    monkeypatch.chdir(FIXTURES)
    arch = st.load_arch(FIXTURES / "arch_hh.yaml")
    net = st.load_net(FIXTURES / "snn_hh.net", arch, True)
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    chip.load(net)
    paths = {t: tmp_path / f"{t}.csv"
             for t in ("spikes", "potentials", "perf", "messages")}
    result = chip.sim(100, timing_model="detailed", heartbeat=0,
                      spike_trace=paths["spikes"],
                      potential_trace=paths["potentials"],
                      perf_trace=paths["perf"],
                      message_trace=(None if device_sweep
                                     else paths["messages"]),
                      device_sweep=device_sweep)
    chip.close()
    assert result["device_engine"] == "scan"
    assert chip.compiled.plugin_shared_max_stride == 3
    _reference_golden("cfg5_hh", chip.format_run_summary(result), tmp_path,
                      TRACES[:3] if device_sweep else TRACES)


# a soma model registered by a user in each package: a leaky integrator of
# its synaptic input, the same arithmetic in jnp and in torch
def _leaky_sum_jax(params, state, valid, current, t):
    v = state["v"] * params["decay"] + params["bias"] + jnp.where(
        valid, current, 0.0)
    fired = v > params["threshold"]
    v = jnp.where(fired, 0.0, v)
    return {"v": v}, fired, valid | fired, v


def _leaky_sum_torch(params, state, valid, current, t):
    v = state["v"] * params["decay"] + params["bias"] + torch.where(
        valid, current, torch.zeros((), dtype=current.dtype))
    fired = v > params["threshold"]
    v = torch.where(fired, torch.zeros((), dtype=v.dtype), v)
    return {"v": v}, fired, valid | fired, v


def _register_leaky_sum():
    spec = dict(params={"threshold": 64.0, "bias": 0.0, "decay": 0.75},
                state={"v": 0.0})
    from sanafe_tpu.models import register_soma_model as jax_register

    from sanafe_tpu_torch.models import register_soma_model

    jax_register("user_leaky_sum", _leaky_sum_jax, **spec)
    register_soma_model("user_leaky_sum", _leaky_sum_torch, **spec)


def _user_model_chip(mod):
    """The random network on two cores, its somas swapped for the
    user-registered model (the bias and threshold attributes reach it)."""
    arch, net = random_chip(mod, cores=2, neurons_per_core=32,
                            messages_per_neuron=2)
    for core in arch.cores():
        for unit in core.pipeline_hw:
            if unit.implements_soma:
                unit.model_info.name = "user_leaky_sum"
    return arch, net


def test_user_registered_model_end_to_end():
    _register_leaky_sum()
    a = loaded(sf, _user_model_chip).sim(STEPS, heartbeat=0, spike_trace=True,
                                         potential_trace=True)
    b = loaded(st, _user_model_chip).sim(STEPS, heartbeat=0, spike_trace=True,
                                         potential_trace=True)
    assert b["device_engine"] == "scan"
    assert a["neurons_fired"] > 0
    assert_results_match(a, b, V_BAR["user"])


PLUGIN_FILE = '''
from sanafe_tpu_torch.models import register_soma_model
from sanafe_tpu_torch.models.hodgkin_huxley import (
    HH_ATTRIBUTES, hodgkin_huxley_update)

LOADS = globals().get("LOADS", 0) + 1
register_soma_model(
    "hh_from_file", hodgkin_huxley_update,
    params={"current": 0.0, "m": 0.0, "n": 0.0, "h": 0.0},
    state={"V": 0.0, "m": 0.0, "n": 0.0, "h": 0.0},
    attributes=HH_ATTRIBUTES, shared_unit_state=True)
'''


def test_py_plugin_file_through_arch(tmp_path, monkeypatch):
    """A ``.py`` plugin named by the arch's ``plugin:`` path registers its
    model when the chip compiles, once per resolved path: cfg5_hh with the
    soma model loaded from such a file is the golden byte for byte."""
    from sanafe_tpu_torch.plugins import load_plugin

    plugin = tmp_path / "hh_plugin.py"
    plugin.write_text(PLUGIN_FILE)
    text = (FIXTURES / "arch_hh.yaml").read_text()
    text = text.replace("model: hodgkin_huxley", "model: hh_from_file")
    text = text.replace('"/tmp/refbuild/plugins/hodgkin_huxley.so"',
                        f'"{plugin}"')
    (tmp_path / "arch.yaml").write_text(text)
    monkeypatch.chdir(FIXTURES)
    arch = st.load_arch(tmp_path / "arch.yaml")
    net = st.load_net(FIXTURES / "snn_hh.net", arch, True)
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float64)
    chip.load(net)
    module = load_plugin(plugin)
    assert load_plugin(str(plugin)) is module and module.LOADS == 1
    assert [s.name for s in chip.compiled.plugin_specs] == ["hh_from_file"]
    out = tmp_path / "out"
    out.mkdir()
    result = chip.sim(100, timing_model="detailed", heartbeat=0,
                      spike_trace=out / "spikes.csv",
                      potential_trace=out / "potentials.csv",
                      perf_trace=out / "perf.csv",
                      message_trace=out / "messages.csv")
    chip.close()
    _reference_golden("cfg5_hh", chip.format_run_summary(result), out)


def test_so_plugin_refused(tmp_path):
    """A native plugin is refused as sanafe_tpu refuses it, naming the
    port's register_soma_model, whether loaded directly or named by an
    unregistered model of the arch."""
    from sanafe_tpu_torch.plugins import load_plugin

    so = tmp_path / "legacy.so"
    so.write_bytes(b"\x7fELF")
    with pytest.raises(RuntimeError,
                       match="sanafe_tpu_torch.models.register_soma_model"):
        load_plugin(so)
    arch = st.load_arch(FIXTURES / "arch_hh.yaml")
    for core in arch.cores():
        for unit in core.pipeline_hw:
            if unit.implements_soma:
                unit.model_info.name = "not_registered_anywhere"
    net = st.load_net(FIXTURES / "snn_hh.net", arch, True)
    with pytest.raises(RuntimeError, match="register_soma_model"):
        st.SpikingChip(arch, device="cpu").load(net)


# --- NeuroFEM noise ------------------------------------------------------------

def test_neurofem_noise_distribution(monkeypatch):
    """With every other dynamic zeroed, a step's potential increment is
    sigma_v times the step's draw: mean within 4 standard errors of 0 and
    standard deviation within 5% of sigma_v; the same timestep gives the
    same draws, another seed other draws."""
    from sanafe_tpu_torch.models import get_model

    spec = get_model("neurofem")
    n, sigma, steps = 64, 0.25, 300
    zeros = torch.zeros(n, dtype=torch.float64)
    params = {key: zeros.clone() for key in spec.param_defaults}
    params.update(sigma_v=torch.full((n,), sigma, dtype=torch.float64),
                  threshold=torch.full((n,), 1e9, dtype=torch.float64),
                  dt=torch.ones(n, dtype=torch.float64))
    comp = torch.zeros((n, 2), dtype=torch.float64)
    valid = torch.zeros(n, dtype=torch.bool)
    state = {key: zeros.clone() for key in spec.state_init}
    # the model's chunk feed: the draws of all the steps at once
    draws = torch.from_numpy(spec.feed(params, 1, steps, range(n)))
    increments, v_prev = [], zeros
    for t in range(1, steps + 1):
        state, _, _, v = spec.soma_update(params, state, valid, zeros,
                                          torch.tensor(t), comp,
                                          feed=draws[t - 1])
        increments.append((v - v_prev).numpy())
        v_prev = v
    samples = np.concatenate(increments)
    assert abs(samples.mean()) < 4 * sigma / np.sqrt(samples.size)
    assert samples.std() == pytest.approx(sigma, rel=0.05)
    fresh = {key: zeros.clone() for key in spec.state_init}

    def first_step():
        feed = torch.from_numpy(spec.feed(params, 1, 1, range(n))[0])
        return spec.soma_update(params, fresh, valid, zeros, torch.tensor(1),
                                comp, feed=feed)[3]

    np.testing.assert_array_equal(first_step().numpy(), increments[0])
    monkeypatch.setenv("SANAFE_TPU_NEUROFEM_SEED", "7")
    assert not np.array_equal(first_step().numpy(), increments[0])


def _noisy_neurofem(mod):
    return neurofem_chip(mod, sigma_v=0.05)


def test_neurofem_noise_split_run_equals_one_run():
    """The draws of step t depend on t alone: 60 steps in one sim() and in
    two give the same raster and potentials bit for bit, and the noise
    moves the potentials off the noiseless run's."""
    one = loaded(st, _noisy_neurofem).sim(60, heartbeat=0, spike_trace=True,
                                          potential_trace=True)
    chip = loaded(st, _noisy_neurofem)
    parts = [chip.sim(k, heartbeat=0, spike_trace=True, potential_trace=True)
             for k in (25, 35)]
    assert raster(one) == raster(parts[0]) + raster(parts[1])
    np.testing.assert_array_equal(
        np.asarray(one["potential_trace"].data),
        np.concatenate([np.asarray(p["potential_trace"].data)
                        for p in parts]))
    quiet = loaded(st, neurofem_chip).sim(60, heartbeat=0,
                                          potential_trace=True)
    assert not np.array_equal(np.asarray(one["potential_trace"].data),
                              np.asarray(quiet["potential_trace"].data))


# --- checkpoints ------------------------------------------------------------

@pytest.mark.parametrize("writer", ["sanafe_tpu", "sanafe_tpu_torch"])
def test_checkpoint_resumes_across_packages(writer, tmp_path):
    """30 steps in one package, a .npz checkpoint, and the next 50 steps
    in both packages from it: the same raster and potentials (within
    1e-12 * max(1, |v|)). The NeuroFEM chip carries LIF state, the
    plugin state and the compartment buffer; the file's keys and dtypes
    are the same whichever package writes it."""
    first, other = (sf, st) if writer == "sanafe_tpu" else (st, sf)
    source = loaded(first, neurofem_chip)
    source.sim(30, heartbeat=0)
    ckpt = tmp_path / "state.npz"
    source.save_state(ckpt)
    target = loaded(other, neurofem_chip)
    target.load_state(ckpt)
    assert target.total_timesteps == 30
    a = source.sim(50, heartbeat=0, spike_trace=True, potential_trace=True)
    b = target.sim(50, heartbeat=0, spike_trace=True, potential_trace=True)
    assert a["timestep_start"] == b["timestep_start"] == 31
    assert a["neurons_fired"] > 0
    assert_results_match(a, b, V_BAR["neurofem"])
    # the other package's file of the same state has the same layout
    again = tmp_path / "again.npz"
    target_state = loaded(other, neurofem_chip)
    target_state.load_state(ckpt)
    target_state.save_state(again)
    with np.load(ckpt) as x, np.load(again) as y:
        assert sorted(x.files) == sorted(y.files)
        assert {"comp_buffer", "plugin_neurofem_u1"} <= set(x.files)
        for key in x.files:
            assert x[key].dtype == y[key].dtype, key
            np.testing.assert_array_equal(x[key], y[key])


def test_checkpoint_paths(tmp_path):
    """A suffix-less path writes and reads ``<path>.npz`` (with a warning
    on write), as sanafe_tpu does without orbax; a directory is a
    torch.distributed.checkpoint, which round-trips; a directory without
    one (such as sanafe_tpu's orbax directories) raises."""
    chip = loaded(st, neurofem_chip)
    chip.sim(5, heartbeat=0)
    with pytest.warns(UserWarning, match="npz"):
        chip.save_state(tmp_path / "ckpt")
    assert (tmp_path / "ckpt.npz").is_file()
    other = loaded(st, neurofem_chip)
    other.load_state(tmp_path / "ckpt")
    assert other.total_timesteps == 5
    for key, value in chip._device_state.items():
        assert torch.equal(value, other._device_state[key]), key
    directory = tmp_path / "state.dcp"
    chip.save_state(directory)
    assert (directory / ".metadata").is_file()
    again = loaded(st, neurofem_chip)
    again.load_state(directory)
    assert again.total_timesteps == 5
    for key, value in chip._device_state.items():
        assert torch.equal(value, again._device_state[key]), key
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        chip.load_state(orbax)


# --- runtime attributes -------------------------------------------------------

def _set_attributes(chip, name):
    groups = chip.mapped_neuron_groups
    if name == "neurofem":
        groups["pre"][0].set_attributes({"threshold": 0.5, "potential": 0.7})
        groups["pre"][3].set_attributes({"bias": 0.9})
        groups["post"][1].set_attributes({"kp": 3.0, "threshold": 0.8})
    else:
        groups["1"][0].set_attributes({"threshold": 12.0, "leak": 1.0})
        groups["0"][0].set_attributes({"potential": 40.0})


@pytest.mark.parametrize("name", ["neurofem", "truenorth"])
def test_set_attributes_between_sims_matches_jax(name):
    """MappedNeuron.set_attributes between two sims (LIF, TrueNorth and
    plugin parameters, a live potential) gives sanafe_tpu's next steps;
    the port rebuilds its programs."""
    builder = neurofem_chip if name == "neurofem" else truenorth_chip
    runs = []
    for mod in (sf, st):
        chip = loaded(mod, builder)
        chip.sim(20, heartbeat=0)
        view = chip.mapped_neuron_groups
        assert sorted(view) == sorted(chip.compiled.groups)
        neuron = next(iter(view.values()))[0]
        assert neuron.id == chip.compiled.neurons[
            chip.compiled.groups[neuron.group_name][0]].global_id
        _set_attributes(chip, name)
        if mod is st:
            assert not chip._programs and not chip._engines
        runs.append((chip.sim(40, heartbeat=0, spike_trace=True,
                              potential_trace=True),
                     [n.get_potential() for group in
                      chip.mapped_neuron_groups.values() for n in group]))
    (a, pa), (b, pb) = runs
    assert a["neurons_fired"] > 0
    assert_results_match(a, b, F64_REL)
    assert_v(pa, pb, F64_REL, "get_potential")


# --- environment knobs --------------------------------------------------------

def _chunk_lengths(chip, monkeypatch):
    lengths = []
    run_chunk = chip._run_chunk

    def record(engine, t0, length, sweep=None):
        lengths.append(length)
        return run_chunk(engine, t0, length, sweep)

    monkeypatch.setattr(chip, "_run_chunk", record)
    return lengths


@pytest.mark.parametrize("knob", ["SANAFE_TPU_ROLLUP_BYTES",
                                  "SANAFE_TPU_EXACT_ENERGY",
                                  "SANAFE_TPU_HEAD_CHUNK",
                                  "SANAFE_TPU_ASYNC_TRACE"])
def test_env_knobs_act_as_in_jax(knob, tmp_path, monkeypatch):
    """Each knob sanafe_tpu reads is read where it reads it and does what
    it does there."""
    from sanafe_tpu.chip import _plan_chunks as jax_plan_chunks
    from sanafe_tpu.ops.step import make_device_program as jax_program

    from sanafe_tpu_torch.ops.step import make_device_program

    if knob == "SANAFE_TPU_ROLLUP_BYTES":
        jax_c, port_c = compile_both("random")
        for value in (None, "0"):
            if value is not None:
                monkeypatch.setenv(knob, value)
            jprog = jax_program(jax_c, dtype=jnp.float32)
            pprog = make_device_program(port_c, "cpu", torch.float32)
            assert pprog.fused_rollup == jprog.fused_rollup == (value is None)
            assert pprog.dense_delivery == jprog.dense_delivery
        chip = loaded(st, random_chip, dtype=torch.float32)
        assert chip.sim(20, heartbeat=0)["device_engine"] == "scan"
    elif knob == "SANAFE_TPU_EXACT_ENERGY":
        for value, exact in ((None, True), ("0", False)):
            if value is not None:
                monkeypatch.setenv(knob, value)
            a = loaded(sf, example_chip).sim(20, heartbeat=0,
                                             perf_trace=True)
            chip = loaded(st, example_chip)
            b = chip.sim(20, heartbeat=0, perf_trace=True)
            assert (chip._exact_energy is not None) == exact
            for key, ref in a["energy"].items():
                assert abs(ref - b["energy"][key]) <= F64_REL * abs(ref)
    elif knob == "SANAFE_TPU_HEAD_CHUNK":
        monkeypatch.setenv(knob, "16")
        chip = loaded(st, neurofem_chip)
        lengths = _chunk_lengths(chip, monkeypatch)
        chip.sim(100, heartbeat=0, chunk=40)
        assert lengths == jax_plan_chunks(100, 40, 16) == [16, 40, 28, 16]
        lengths.clear()
        chip.sim(100, timing_model="simple", heartbeat=0, chunk=40)
        assert lengths == [40, 40, 20]
    else:
        files = []
        for value in (None, "0"):
            if value is not None:
                monkeypatch.setenv(knob, value)
            chip = loaded(st, neurofem_chip)
            writers = []
            submit = chip._submit

            def record(sink, data, chip=chip, submit=submit):
                writers.append(chip._trace_writer is not None)
                return submit(sink, data)

            monkeypatch.setattr(chip, "_submit", record)
            path = tmp_path / f"spikes_{value}.csv"
            chip.sim(40, heartbeat=0, spike_trace=path)
            chip.close()
            assert writers and set(writers) == {value is None}
            files.append(path.read_bytes())
        assert files[0] == files[1] and files[0].count(b"\n") > 1
