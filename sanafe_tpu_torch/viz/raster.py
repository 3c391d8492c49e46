"""Spike raster plot (reference sanafe/viz/raster.py)."""

from __future__ import annotations


from ..data import spikes_to_dataframe
from .styles import apply_style, get_group_colors


def plot_raster(source, groups=None, time_range=None, ax=None, style=None,
                marker="|", **kwargs):
    """Scatter-style spike raster; one row per neuron, colored by group."""
    from matplotlib import pyplot as plt

    df = spikes_to_dataframe(source)
    if groups is not None:
        df = df[df["group"].isin(groups)]
    with apply_style(style):
        if ax is None:
            _, ax = plt.subplots()
        if df.empty:
            ax.set_xlabel("Timestep")
            ax.set_ylabel("Neuron")
            return ax
        if time_range is not None:
            start, stop = time_range
            df = df[(df["timestep"] >= start) & (df["timestep"] < stop)]
        labels = sorted(df["neuron_id"].unique())
        row_of = {label: i for i, label in enumerate(labels)}
        colors = get_group_colors(df["group"], style)
        for group, sub in df.groupby("group"):
            ax.scatter(
                sub["timestep"],
                [row_of[n] for n in sub["neuron_id"]],
                marker=marker,
                color=colors[group],
                label=group,
                **kwargs,
            )
        ax.set_yticks(range(len(labels)))
        ax.set_yticklabels(labels)
        ax.set_xlabel("Timestep")
        ax.set_ylabel("Neuron")
        ax.legend(loc="best", fontsize="small")
    return ax
