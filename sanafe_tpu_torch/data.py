"""Trace-data converters: simulator outputs → numpy/pandas.

Mirrors the reference's ``sanafe/data.py`` API: each converter accepts a
pandas DataFrame, a CSV path, the dict returned by ``chip.sim()``, or the
raw in-memory trace value, and returns tidy pandas structures. A copy of
``sanafe_tpu/data.py`` that imports pandas in each converter, on first
use, so the package imports without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from .trace import NeuronAddress


def _is_path(source: Any) -> bool:
    return isinstance(source, (str, Path))


def _maybe_unwrap(source: Any, key: str) -> Any:
    """Pull a trace out of a chip.sim() result dict."""
    if isinstance(source, dict) and key in source:
        return source[key]
    return source


def _trace_data(source: Any):
    """Unwrap in-memory trace objects (SpikeTrace etc.) to their data."""
    return getattr(source, "data", source)


def spikes_to_dataframe(source: Any) -> pd.DataFrame:
    """Spike trace → DataFrame with columns timestep / group /
    neuron_offset / neuron_id (reference sanafe/data.py:122-170)."""
    import pandas as pd

    if isinstance(source, pd.DataFrame):
        df = source.copy()
        if "neuron" in df.columns and "group" not in df.columns:
            parts = df["neuron"].astype(str).str.rsplit(".", n=1, expand=True)
            df["group"] = parts[0]
            df["neuron_offset"] = parts[1].astype(int)
            df["neuron_id"] = df["neuron"]
        return df
    if _is_path(source):
        return spikes_to_dataframe(pd.read_csv(source))
    source = _trace_data(_maybe_unwrap(source, "spike_trace"))
    if source is None:
        raise ValueError("No spike trace data found in source")
    rows = []
    for step, fired in enumerate(source, start=1):
        for address in fired:
            if isinstance(address, NeuronAddress):
                group, offset = address.group_name, address.neuron_offset
            else:
                group, offset = address
            rows.append(
                {
                    "timestep": step,
                    "group": group,
                    "neuron_offset": offset,
                    "neuron_id": f"{group}.{offset}",
                }
            )
    return pd.DataFrame(
        rows, columns=["timestep", "group", "neuron_offset", "neuron_id"]
    )


def spikes_to_raster(
    source: Any,
    groups: Optional[Sequence[str]] = None,
    time_range: Optional[Tuple[int, int]] = None,
    n_timesteps: Optional[int] = None,
) -> Tuple[np.ndarray, list, np.ndarray]:
    """Spike trace → dense 2D raster (neurons × timesteps); returns
    (matrix, row labels, timestep values) — reference sanafe/data.py:37-120.
    """
    df = spikes_to_dataframe(source)
    if df.empty:
        return np.zeros((0, 0), dtype=bool), [], np.zeros(0, dtype=int)
    if groups is None:
        groups = sorted(df["group"].unique())
    df = df[df["group"].isin(groups)]
    if time_range is not None:
        start, stop = time_range
    elif n_timesteps is not None:
        start, stop = 1, n_timesteps + 1
    else:
        start, stop = int(df["timestep"].min()), int(df["timestep"].max()) + 1
    timesteps = np.arange(start, stop)
    labels = []
    for group in groups:
        offsets = sorted(
            df.loc[df["group"] == group, "neuron_offset"].unique()
        )
        labels.extend(f"{group}.{offset}" for offset in offsets)
    row_of = {label: i for i, label in enumerate(labels)}
    raster = np.zeros((len(labels), len(timesteps)), dtype=bool)
    in_window = (df["timestep"] >= start) & (df["timestep"] < stop)
    for _, row in df[in_window].iterrows():
        raster[row_of[row["neuron_id"]], row["timestep"] - start] = True
    return raster, labels, timesteps


def potentials_to_dataframe(
    source: Any, neuron_ids: Sequence[str] | None = None
) -> pd.DataFrame:
    """Potential trace → DataFrame indexed by timestep
    (reference sanafe/data.py:172-222)."""
    import pandas as pd

    if isinstance(source, pd.DataFrame):
        df = source.copy()
        if "timestep" in df.columns:
            df = df.set_index("timestep")
        return df
    if _is_path(source):
        df = pd.read_csv(source)
        df = df.loc[:, ~df.columns.str.match(r"^Unnamed")]
        return df.set_index("timestep")
    source = _trace_data(_maybe_unwrap(source, "potential_trace"))
    if source is None:
        raise ValueError("No potential trace data found in source")
    matrix = np.asarray(source, dtype=float)
    n_cols = matrix.shape[1] if matrix.ndim == 2 else 0
    if neuron_ids is None:
        neuron_ids = [f"Neuron {i}" for i in range(n_cols)]
    if len(neuron_ids) != n_cols:
        raise ValueError(
            f"neuron_ids length ({len(neuron_ids)}) does not match trace "
            f"columns ({n_cols})"
        )
    df = pd.DataFrame(matrix, columns=list(neuron_ids))
    df.index = pd.RangeIndex(1, len(df) + 1, name="timestep")
    return df


def neuron_traces_to_dataframe(
    source: Any, neuron_ids: Sequence[str] | None = None
) -> pd.DataFrame:
    """Model-defined neuron traces → long DataFrame (timestep, neuron,
    trace name, value) — reference sanafe/data.py:224-323."""
    import pandas as pd

    if isinstance(source, pd.DataFrame):
        return source.copy()
    if _is_path(source):
        return pd.read_csv(source)
    source = _maybe_unwrap(source, "neuron_trace")
    data = _trace_data(source)
    if data is None:
        raise ValueError("No neuron trace data found in source")
    rows = []
    for trace_name, per_step in data.items():
        for step, values in enumerate(per_step, start=1):
            for idx, value in enumerate(values):
                neuron = (
                    neuron_ids[idx] if neuron_ids else f"Neuron {idx}"
                )
                rows.append(
                    {
                        "timestep": step,
                        "neuron": neuron,
                        "trace": trace_name,
                        "value": value,
                    }
                )
    return pd.DataFrame(rows, columns=["timestep", "neuron", "trace", "value"])


def performance_to_dataframe(source: Any) -> pd.DataFrame:
    """Performance trace → per-timestep DataFrame
    (reference sanafe/data.py:325-355)."""
    import pandas as pd

    if isinstance(source, pd.DataFrame):
        return source.copy()
    if _is_path(source):
        return pd.read_csv(source)
    source = _maybe_unwrap(source, "perf_trace")
    data = _trace_data(source)
    if data is None:
        raise ValueError("No performance trace data found in source")
    return pd.DataFrame(dict(data))


def messages_to_dataframe(source: Any) -> pd.DataFrame:
    """Message trace → one row per message, with derived src_neuron /
    src_hw / dest_hw identifier columns (reference sanafe/data.py:357-403).
    """
    import pandas as pd

    if isinstance(source, pd.DataFrame):
        return source.copy()
    if _is_path(source):
        return pd.read_csv(source)
    source = _maybe_unwrap(source, "message_trace")
    data = _trace_data(source)
    if data is None:
        raise ValueError("No message trace data found in source")
    rows = [dict(message) for per_step in data for message in per_step]
    df = pd.DataFrame(rows)
    if {"src_neuron_group_id", "src_neuron_offset"}.issubset(df.columns):
        df["src_neuron"] = (
            df["src_neuron_group_id"].astype(str)
            + "."
            + df["src_neuron_offset"].astype(str)
        )
    if {"src_tile_id", "src_core_offset"}.issubset(df.columns):
        df["src_hw"] = (
            df["src_tile_id"].astype(str)
            + "."
            + df["src_core_offset"].astype(str)
        )
    if {"dest_tile_id", "dest_core_offset"}.issubset(df.columns):
        df["dest_hw"] = (
            df["dest_tile_id"].astype(str)
            + "."
            + df["dest_core_offset"].astype(str)
        )
    return df
