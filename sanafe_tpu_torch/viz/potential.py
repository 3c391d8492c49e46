"""Membrane potential plots (reference sanafe/viz/potential.py)."""

from __future__ import annotations


from ..data import potentials_to_dataframe
from .styles import apply_style


def plot_potential(source, neuron=None, neuron_ids=None, ax=None,
                   style=None, **kwargs):
    """Plot one neuron's membrane potential over time."""
    from matplotlib import pyplot as plt

    df = potentials_to_dataframe(source, neuron_ids)
    with apply_style(style):
        if ax is None:
            _, ax = plt.subplots()
        column = neuron if neuron is not None else df.columns[0]
        ax.plot(df.index, df[column], **kwargs)
        ax.set_xlabel("Timestep")
        ax.set_ylabel("Potential")
        ax.set_title(str(column))
    return ax


def plot_potential_lines(source, neurons=None, neuron_ids=None, ax=None,
                         style=None, **kwargs):
    """Plot several neurons' potentials as overlaid lines."""
    from matplotlib import pyplot as plt

    df = potentials_to_dataframe(source, neuron_ids)
    with apply_style(style):
        if ax is None:
            _, ax = plt.subplots()
        columns = neurons if neurons is not None else list(df.columns)
        for column in columns:
            ax.plot(df.index, df[column], label=str(column), **kwargs)
        ax.set_xlabel("Timestep")
        ax.set_ylabel("Potential")
        ax.legend(loc="best", fontsize="small")
    return ax
