"""Plot style system (reference sanafe/viz/styles.py)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace



@dataclass
class SANAFEStyle:
    """A named bundle of matplotlib rc settings + palette."""

    name: str = "default"
    font_size: float = 10.0
    label_size: float = 11.0
    title_size: float = 12.0
    line_width: float = 1.5
    marker_size: float = 4.0
    figure_size: tuple = (6.0, 4.0)
    dpi: int = 100
    grid: bool = True
    palette: list = field(
        default_factory=lambda: [
            "#4477AA", "#EE6677", "#228833", "#CCBB44",
            "#66CCEE", "#AA3377", "#BBBBBB",
        ]
    )

    def rc_params(self) -> dict:
        return {
            "font.size": self.font_size,
            "axes.labelsize": self.label_size,
            "axes.titlesize": self.title_size,
            "lines.linewidth": self.line_width,
            "lines.markersize": self.marker_size,
            "figure.figsize": self.figure_size,
            "figure.dpi": self.dpi,
            "axes.grid": self.grid,
        }


PUBLICATION_STYLE = SANAFEStyle(
    name="publication", font_size=8, label_size=9, title_size=10,
    figure_size=(3.5, 2.5), dpi=300, grid=False,
)
PRESENTATION_STYLE = SANAFEStyle(
    name="presentation", font_size=14, label_size=16, title_size=18,
    figure_size=(10, 6), dpi=120, line_width=2.5,
)
NOTEBOOK_STYLE = SANAFEStyle(name="notebook")

_default_style = NOTEBOOK_STYLE


def set_default_style(style: SANAFEStyle) -> None:
    global _default_style
    _default_style = style


def get_default_style() -> SANAFEStyle:
    return _default_style


def apply_style(style: SANAFEStyle | None = None):
    """Context manager applying a style's rc params."""
    import matplotlib as mpl

    style = style or _default_style
    return mpl.rc_context(style.rc_params())


def get_group_colors(groups, style: SANAFEStyle | None = None) -> dict:
    """Stable color assignment for a set of group names."""
    style = style or _default_style
    palette = style.palette
    if len(set(groups)) > len(palette):
        palette = extended_palette(style)
    return {
        group: palette[i % len(palette)]
        for i, group in enumerate(sorted(set(groups)))
    }


def extended_palette(style: SANAFEStyle | None = None) -> list:
    """The style palette extended with additional distinguishable hues for
    plots with many groups (reference EXTENDED_COLORS)."""
    style = style or _default_style
    return list(style.palette) + [
        "#004488", "#997700", "#994455", "#117733",
        "#88CCEE", "#DDCC77", "#CC6677", "#332288",
    ]


def get_colormap(name: str = "neuromorphic", n_colors: int = 256):
    """Continuous colormaps for heatmaps: 'neuromorphic' (dark blue →
    teal → yellow, the reference's NEUROMORPHIC_CMAP), 'energy' (white →
    red), or any matplotlib colormap name."""
    from matplotlib import pyplot as plt

    from matplotlib.colors import LinearSegmentedColormap

    if name == "neuromorphic":
        return LinearSegmentedColormap.from_list(
            "neuromorphic",
            ["#0B1354", "#1F6E8C", "#2EB8A5", "#A7E030", "#FDE725"],
            N=n_colors,
        )
    if name == "energy":
        return LinearSegmentedColormap.from_list(
            "energy", ["#FFFFFF", "#FFD166", "#EF476F", "#9D0208"],
            N=n_colors,
        )
    return plt.get_cmap(name, n_colors)


def create_figure(
    nrows: int = 1,
    ncols: int = 1,
    style: SANAFEStyle | None = None,
    **subplot_kwargs,
):
    """Create a styled (fig, axes) pair under the given style's rc params
    (reference styles.create_figure)."""
    import matplotlib as mpl
    from matplotlib import pyplot as plt

    style = style or _default_style
    with mpl.rc_context(style.rc_params()):
        fig, axes = plt.subplots(nrows, ncols, **subplot_kwargs)
    return fig, axes


def style_axis(
    ax,
    title: str | None = None,
    xlabel: str | None = None,
    ylabel: str | None = None,
    style: SANAFEStyle | None = None,
    legend: bool = False,
) -> None:
    """Apply the style's labeling conventions to an axis
    (reference styles.style_axis)."""
    style = style or _default_style
    if title:
        ax.set_title(title, fontsize=style.title_size)
    if xlabel:
        ax.set_xlabel(xlabel, fontsize=style.label_size)
    if ylabel:
        ax.set_ylabel(ylabel, fontsize=style.label_size)
    ax.tick_params(labelsize=style.font_size)
    if style.grid:
        ax.grid(True, alpha=0.3)
    if legend:
        ax.legend(fontsize=style.font_size)
