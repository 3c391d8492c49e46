"""Visualization helpers (reference sanafe/viz/), copied from
``sanafe_tpu/viz``: each plot imports matplotlib when it is called."""

from .raster import plot_raster
from .potential import plot_potential, plot_potential_lines
from .performance import plot_energy, plot_throughput, plot_message_latency
from .styles import (
    SANAFEStyle,
    create_figure,
    extended_palette,
    get_colormap,
    get_group_colors,
    apply_style,
    set_default_style,
    style_axis,
    PUBLICATION_STYLE,
    PRESENTATION_STYLE,
    NOTEBOOK_STYLE,
)

__all__ = [
    "plot_raster",
    "plot_potential",
    "plot_potential_lines",
    "plot_energy",
    "plot_throughput",
    "plot_message_latency",
    "SANAFEStyle",
    "create_figure",
    "extended_palette",
    "get_colormap",
    "get_group_colors",
    "style_axis",
    "apply_style",
    "set_default_style",
    "PUBLICATION_STYLE",
    "PRESENTATION_STYLE",
    "NOTEBOOK_STYLE",
]
