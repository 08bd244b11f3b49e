"""Regional / banded aggregation drivers for the lagged-xcov EDA suite.

Counterpart of ``cokriging_tpu/stats/regional.py``: pandas on the host
(imported inside the functions, so ``stats.spacetime`` loads none), the
statistics through ``stats.spacetime`` on ``device`` (the card unless
``device="cpu"``).

The reference runs this analysis as ~1,600 LoC of notebook workflows at
several aggregation levels — per 5-degree cell
(notebooks/5degree_monthly_xcov.ipynb cells 6-7), per TransCom region
(notebooks/transcom_monthly_xcov.ipynb cells 4-6), per hemisphere
(notebooks/hemisphere_monthly.ipynb), per latitude band and globally
(notebooks/global_*.ipynb). This module factors those workflows into
reusable drivers over the stats primitives (stats.spacetime):

- ``to_cubes``: long monthly frame -> dense (n_lat, n_lon, T) cubes, the
  layout ``get_stats`` / ``apply_xcor`` / ``optim_lag_nd`` vectorize over;
- ``gridded_stats``: the per-cell driver (counts/slopes/stds + lagged
  xcor maps) — one call reproduces 5degree_monthly_xcov cell 6;
- ``map_transcom``: tag observations with their TransCom-3 region
  (reference src/data_utils.py:344-360, commented-out there; the TransCom
  notebook inlines it in cell 4);
- ``hemisphere_labels`` / ``lat_band_labels``: the other groupers;
- ``regional_monthly``: group -> monthly-mean series;
- ``regional_stats``: group -> ``get_stats_df`` summary rows (slopes,
  residual stds, lagged xcors per region/band/hemisphere);
- ``stats_to_grid``: broadcast per-region stats back onto cells for maps
  (transcom_monthly_xcov cell 6).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

import numpy as np

from cokriging_tpu_torch.stats.spacetime import apply_xcor, get_stats, get_stats_df

if TYPE_CHECKING:
    import pandas as pd


def to_cubes(
    df: pd.DataFrame, value_cols: Sequence[str]
) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
    """Pivot a long monthly frame (time, lat, lon, values...) into dense
    (n_lat, n_lon, T) cubes with NaN holes.

    Replaces the reference's ``set_index([...]).to_xarray()``
    (5degree_monthly_xcov cell 6) with a plain dense layout — the shape
    the per-cell reductions vectorize over.

    Returns (cubes, lats, lons, times).
    """
    lats = np.sort(df["lat"].unique())
    lons = np.sort(df["lon"].unique())
    times = np.sort(df["time"].unique())
    li = {v: k for k, v in enumerate(lats)}
    lo = {v: k for k, v in enumerate(lons)}
    ti = {v: k for k, v in enumerate(times)}
    ii = df["lat"].map(li).values
    jj = df["lon"].map(lo).values
    kk = df["time"].map(ti).values
    cubes = {}
    for col in value_cols:
        cube = np.full((len(lats), len(lons), len(times)), np.nan)
        cube[ii, jj, kk] = df[col].values.astype(float)
        cubes[col] = cube
    return cubes, lats, lons, times


def gridded_stats(
    df: pd.DataFrame,
    value_cols: Sequence[str] = ("sif", "xco2"),
    lags: Sequence[int] = (1, 2),
    tau: Optional[int] = 30,
    device=None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """Per-cell EDA maps: counts/slopes/residual-stds for each variable
    plus detrended lagged cross-correlations xcor_lag<k> (xco2 vs sif).

    One call = 5degree_monthly_xcov.ipynb cell 6:
        get_stats + apply_xcor(lag=1) + apply_xcor(lag=2).

    Returns (stat maps dict of (n_lat, n_lon) arrays, lats, lons).
    """
    cubes, lats, lons, _ = to_cubes(df, value_cols)
    out = get_stats(cubes, device=device)
    if len(value_cols) == 2:
        a, b = value_cols  # (sif, xco2) -> xcor(xco2, sif) like the nb
        for lag in lags:
            out[f"xcor_lag{lag}"] = apply_xcor(
                cubes[b], cubes[a], lag=lag, tau=tau, device=device
            )
    return out, lats, lons


def map_transcom(df: pd.DataFrame, df_tc: pd.DataFrame) -> pd.DataFrame:
    """Tag observation rows with their TransCom-3 region by snapping
    coordinates to the 1-degree region-map cells and merging
    (reference src/data_utils.py:344-360; transcom_monthly_xcov cell 4)."""
    out = df.copy()
    out["lon"] = np.floor(out["lon"]) + 0.5
    out["lat"] = np.floor(out["lat"]) + 0.5
    return (
        out.merge(df_tc, on=["lon", "lat"], how="inner")
        .drop(columns=["lon", "lat"])
        .dropna(subset=["region"])
        .reset_index(drop=True)
    )


def hemisphere_labels(df: pd.DataFrame) -> pd.Series:
    """'north' (lat >= 0) / 'south' grouper (hemisphere_monthly cell 2)."""
    import pandas as pd

    return pd.Series(
        np.where(df["lat"].values >= 0, "north", "south"), index=df.index,
        name="hemisphere",
    )


def lat_band_labels(df: pd.DataFrame, width: float = 30.0) -> pd.Series:
    """Latitude-band center grouper (the 30-degree-band workflows)."""
    import pandas as pd

    centers = np.floor(df["lat"].values / width) * width + width / 2
    return pd.Series(centers, index=df.index, name="lat_band")


def regional_monthly(
    df: pd.DataFrame,
    by,
    value_cols: Sequence[str] = ("sif", "xco2"),
) -> pd.DataFrame:
    """Group observations (by a column name or a label Series) and average
    to monthly series per group — the `groupby(...).resample('1MS').mean()`
    stage of every regional notebook."""
    key = df[by] if isinstance(by, str) else by
    name = key.name or "group"
    out = (
        df.assign(**{name: key.values})
        .groupby(name)
        .resample("1MS", on="time")[list(value_cols)]
        .mean()
        .reset_index()
    )
    return out


def regional_stats(
    df_monthly: pd.DataFrame,
    by: str,
    lags: Sequence[int] = (1, 2),
    tau: Optional[int] = None,
    device=None,
) -> pd.DataFrame:
    """Per-group counts/slopes/stds/lagged-xcors: groupby -> get_stats_df
    (transcom_monthly_xcov cell 5). ``df_monthly`` is regional_monthly's
    output (one row per group x month, sif/xco2 columns)."""
    import pandas as pd

    frames = []
    for g, grp in df_monthly.groupby(by):
        row = get_stats_df(grp.sort_values("time"), lags=lags, tau=tau, device=device)
        row.insert(0, by, g)
        frames.append(row)
    return pd.concat(frames, ignore_index=True)


def stats_to_grid(
    df_stats: pd.DataFrame, df_regions: pd.DataFrame, on: str = "region"
) -> pd.DataFrame:
    """Broadcast per-region stats back to the region map's cells so they
    can be drawn as maps (transcom_monthly_xcov cell 6)."""
    return df_regions.merge(df_stats, on=on, how="inner").reset_index(
        drop=True
    )
