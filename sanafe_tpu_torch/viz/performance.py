"""Performance/energy/message plots (reference sanafe/viz/performance.py)."""

from __future__ import annotations


from ..data import messages_to_dataframe, performance_to_dataframe
from .styles import apply_style


ENERGY_COLUMNS = (
    "synapse_energy", "dendrite_energy", "soma_energy", "network_energy",
)


def plot_energy(source, stacked=True, ax=None, style=None, **kwargs):
    """Per-timestep energy split by hardware category."""
    from matplotlib import pyplot as plt

    df = performance_to_dataframe(source)
    with apply_style(style):
        if ax is None:
            _, ax = plt.subplots()
        columns = [c for c in ENERGY_COLUMNS if c in df.columns]
        x = df["timestep"] if "timestep" in df.columns else df.index
        if stacked:
            ax.stackplot(
                x, [df[c] for c in columns],
                labels=[c.replace("_energy", "") for c in columns], **kwargs,
            )
        else:
            for c in columns:
                ax.plot(x, df[c], label=c.replace("_energy", ""), **kwargs)
        ax.set_xlabel("Timestep")
        ax.set_ylabel("Energy (J)")
        ax.legend(loc="best", fontsize="small")
    return ax


def plot_throughput(source, window=100, ax=None, style=None, **kwargs):
    """Simulated throughput: timesteps per second of chip time (1/sim_time),
    smoothed over a rolling window."""
    from matplotlib import pyplot as plt

    df = performance_to_dataframe(source)
    with apply_style(style):
        if ax is None:
            _, ax = plt.subplots()
        x = df["timestep"] if "timestep" in df.columns else df.index
        throughput = 1.0 / df["sim_time"].replace(0.0, float("nan"))
        if window > 1:
            throughput = throughput.rolling(window, min_periods=1).mean()
        ax.plot(x, throughput, **kwargs)
        ax.set_xlabel("Timestep")
        ax.set_ylabel("Throughput (timesteps/s)")
    return ax


def plot_message_latency(source, bins=50, ax=None, style=None, **kwargs):
    """Histogram of per-message network latency."""
    from matplotlib import pyplot as plt

    df = messages_to_dataframe(source)
    with apply_style(style):
        if ax is None:
            _, ax = plt.subplots()
        latency = df["network_delay"] + df["blocking_delay"]
        ax.hist(latency.dropna(), bins=bins, **kwargs)
        ax.set_xlabel("Message latency (s)")
        ax.set_ylabel("Messages")
    return ax
