"""The port's copies of sanafe_tpu's trace converters (``data``) and plots
(``viz``), the counterparts of ``tests/test_package.py``'s converter and viz
tests, on the same ``load_example()`` run (16 detailed steps with every
trace in memory) simulated on the CPU; and the package's exports.

The converters give the same DataFrames as sanafe_tpu's on the two
packages' runs of the same chip. ``import sanafe_tpu_torch`` imports
neither pandas nor matplotlib: a subprocess that blocks both (and JAX)
imports the package, ``data``, ``viz``, ``lava`` and ``fugu``, and builds a
``ParameterSweep``.
"""

import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

import sanafe_tpu as sf  # noqa: E402
import sanafe_tpu_torch as st  # noqa: E402
from sanafe_tpu_torch.data import (  # noqa: E402
    messages_to_dataframe,
    neuron_traces_to_dataframe,
    performance_to_dataframe,
    potentials_to_dataframe,
    spikes_to_dataframe,
    spikes_to_raster,
)

REPO = Path(__file__).resolve().parent.parent


def _example_run(mod, **chip_kwargs):
    arch, net = mod.load_example()
    chip = mod.SpikingChip(arch, **chip_kwargs)
    chip.load(net)
    return chip.sim(16, timing_model="detailed", spike_trace=True,
                    potential_trace=True, perf_trace=True,
                    message_trace=True, heartbeat=0)


@pytest.fixture(scope="module")
def example_result():
    return _example_run(st, device="cpu")


@pytest.fixture(scope="module")
def jax_result():
    return _example_run(sf)


def test_example_runs(example_result):
    assert example_result["spikes"] > 0
    assert example_result["energy"]["total"] > 0
    assert example_result["sim_time"] > 0


def test_spikes_converters(example_result, jax_result):
    from sanafe_tpu.data import spikes_to_dataframe as jax_spikes

    df = spikes_to_dataframe(example_result)
    assert set(df.columns) == {
        "timestep", "group", "neuron_offset", "neuron_id",
    }
    pd.testing.assert_frame_equal(df, jax_spikes(jax_result))
    raster, labels, steps = spikes_to_raster(example_result, n_timesteps=16)
    assert raster.shape == (len(labels), 16)
    assert raster.sum() == len(df)


def test_potentials_converter(example_result, jax_result):
    from sanafe_tpu.data import potentials_to_dataframe as jax_potentials

    df = potentials_to_dataframe(example_result)
    assert df.index.name == "timestep"
    assert len(df) == 16
    assert df.shape[1] == 5  # 4 hidden + 1 out log_potential neurons
    pd.testing.assert_frame_equal(df, jax_potentials(jax_result))


def test_performance_converter(example_result, jax_result):
    from sanafe_tpu.data import performance_to_dataframe as jax_perf

    df = performance_to_dataframe(example_result)
    assert "sim_time" in df.columns and len(df) == 16
    ref = jax_perf(jax_result)
    assert list(df.columns) == list(ref.columns)
    np.testing.assert_allclose(df.to_numpy(dtype=float),
                               ref.to_numpy(dtype=float), rtol=1e-6)


def test_messages_converter(example_result, jax_result):
    from sanafe_tpu.data import messages_to_dataframe as jax_messages

    df = messages_to_dataframe(example_result)
    assert {"src_neuron", "src_hw", "dest_hw"}.issubset(df.columns)
    assert (df["mid"] >= -1).all()
    ref = jax_messages(jax_result)
    assert list(df.columns) == list(ref.columns) and len(df) == len(ref)
    pd.testing.assert_series_equal(df["src_neuron"], ref["src_neuron"])


def test_csv_and_frame_sources(example_result, tmp_path):
    """Each converter also takes a CSV path and a DataFrame."""
    df = spikes_to_dataframe(example_result)
    path = tmp_path / "spikes.csv"
    df.to_csv(path, index=False)
    pd.testing.assert_frame_equal(spikes_to_dataframe(path), df)
    pd.testing.assert_frame_equal(spikes_to_dataframe(df), df)
    perf = performance_to_dataframe(example_result)
    pd.testing.assert_frame_equal(performance_to_dataframe(perf), perf)
    assert neuron_traces_to_dataframe(perf).equals(perf)


def test_viz_plots(example_result, tmp_path):
    from sanafe_tpu_torch.viz import (
        PUBLICATION_STYLE,
        create_figure,
        get_colormap,
        plot_energy,
        plot_message_latency,
        plot_potential,
        plot_potential_lines,
        plot_raster,
        plot_throughput,
    )

    ax = plot_raster(example_result, style=PUBLICATION_STYLE)
    ax.figure.savefig(tmp_path / "raster.png")
    ax = plot_potential_lines(example_result)
    ax.figure.savefig(tmp_path / "potentials.png")
    ax = plot_potential(example_result)
    ax.figure.savefig(tmp_path / "potential.png")
    ax = plot_energy(example_result)
    ax.figure.savefig(tmp_path / "energy.png")
    ax = plot_throughput(example_result, window=4)
    ax.figure.savefig(tmp_path / "throughput.png")
    ax = plot_message_latency(example_result)
    ax.figure.savefig(tmp_path / "latency.png")
    fig, _ = create_figure(1, 2)
    fig.savefig(tmp_path / "figure.png")
    assert get_colormap("neuromorphic").N == 256
    assert (tmp_path / "raster.png").stat().st_size > 0


def test_exports_match_sanafe_tpu():
    """Every name sanafe_tpu exports, the port exports (load_truenorth
    besides)."""
    missing = [name for name in sf.__all__ if not hasattr(st, name)]
    assert not missing
    assert set(sf.__all__) <= set(st.__all__)
    assert st.__version__ == sf.__version__
    for name in ("BufferPosition", "CoreConfiguration", "TileConfiguration",
                 "Connection", "Conv2DParameters", "Neuron", "NeuronGroup",
                 "NeuronAddress"):
        assert getattr(st, name).__module__.startswith("sanafe_tpu_torch."), (
            name)
    assert st.data.__name__ == "sanafe_tpu_torch.data"


def test_package_imports_without_pandas_or_matplotlib():
    """pandas, matplotlib and JAX blocked: the package, its data, viz, lava
    and fugu modules import, and a ParameterSweep runs; the first converter
    call then fails for want of pandas."""
    code = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "matplotlib", "jax",
                                  "sanafe_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import numpy as np
import sanafe_tpu_torch as st
from sanafe_tpu_torch import data, fugu, lava, viz
arch, net = st.load_example()
chip = st.SpikingChip(arch, device="cpu")
chip.load(net)
over = st.expand_group_values(chip.compiled, "threshold",
                              {name: np.array([0.5, 2.0])
                               for name in chip.compiled.groups})
out = st.ParameterSweep(chip, {"threshold": over}).run(5)
assert out["neurons_updated"].shape == (2,)
result = chip.sim(3, spike_trace=True, heartbeat=0)
try:
    data.spikes_to_dataframe(result)
except ImportError as exc:
    assert "pandas" in str(exc)
else:
    raise AssertionError("pandas was imported")
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("pandas", "matplotlib", "jax")]
assert not loaded, loaded
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
