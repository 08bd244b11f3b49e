"""Regular lat/lon grids, land masking, and the micro-offset augmentation.

Counterpart of ``cokriging_tpu/data/grids.py``. The grids themselves are
numpy only: ``GridConfig``, ``SpatialGrid``, ``land_grid``,
``main_coords_array`` and ``prediction_coords`` (src/data_utils.py:122-216,
304-328; src/point_prediction.py:349-355). Where the JAX package goes
through pandas there, this module reproduces it: ``pd.cut``'s right-closed
binning (values on the lowest edge fall outside) and the (lon, lat) key
order of a pandas groupby, so both packages return the same cells in the
same order.

The wrangling of long-format frames [time, lat, lon, <vars>...] is the JAX
package's pandas code (src/data_utils.py:179-372): ``regrid``,
``temporal_avg``/``monthly_avg``, ``apply_land_mask``, ``prep_gridded_df``,
the 17-offset ``augment_dataset`` (and the 80-offset
``augment_dataset_pred``), ``produce_climatology_conus`` and ``to_frame``.
Those functions import pandas when called, so the array path never loads it.
"""

import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np

CONUS_EXTENTS = (-125, -65, 22, 58)  # (lon_min, lon_max, lat_min, lat_max)


@dataclass(frozen=True)
class GridConfig:
    """Grid spec: extents (lon_min, lon_max, lat_min, lat_max), resolution,
    and center offsets (src/data_utils.py:122-142)."""

    extents: Tuple[float, float, float, float] = (-180, 180, -90, 90)
    lon_res: float = 1.0
    lat_res: float = 1.0
    lon_offset: float = 0.0
    lat_offset: float = 0.0

    def __post_init__(self):
        if self.lon_offset != 0 and self.lat_offset != 0:
            warnings.warn("Both lon_offset and lat_offset are nonzero.")

    @property
    def lon_bounds(self):
        return _prep_bounds(self.extents[:2], self.lon_res, self.lon_offset)

    @property
    def lat_bounds(self):
        return _prep_bounds(self.extents[2:], self.lat_res, self.lat_offset)


def _prep_bounds(bounds, res, offset):
    """Pad bounds by half a cell and shift by the offset
    (src/data_utils.py:166-170)."""
    half = 0.5 * res * np.array([-1.0, 1.0])
    return tuple(np.asarray(bounds, float) + half + offset)


def _prep_bins(bounds, res):
    edges = np.arange(bounds[0], bounds[1] + res, res)
    centers = (edges[1:] + edges[:-1]) / 2
    return edges, centers


class SpatialGrid:
    """Bin edges and centers for a GridConfig (src/data_utils.py:145-163)."""

    def __init__(self, config: GridConfig) -> None:
        self.config = config
        self.lon_bins, self.lon_centers = _prep_bins(config.lon_bounds, config.lon_res)
        self.lat_bins, self.lat_centers = _prep_bins(config.lat_bounds, config.lat_res)

    def bounds_check(self, df) -> None:
        """Warn when a frame's lon/lat run outside the grid's bin edges."""
        if not (
            self.lon_bins.min() <= df.lon.min()
            and self.lon_bins.max() >= df.lon.max()
            and self.lat_bins.min() <= df.lat.min()
            and self.lat_bins.max() >= df.lat.max()
        ):
            warnings.warn(
                "Dataset coordinates not within grid extents; may produce"
                f" unexpected behavior: ({df.lon.min()}, {df.lon.max()},"
                f" {df.lat.min()}, {df.lat.max()})"
            )


def _cut(x, edges, centers):
    """``pd.cut(x, edges, labels=centers)``: the center of the right-closed
    bin (edges[k], edges[k + 1]] holding each value, NaN outside."""
    k = np.searchsorted(edges, x, side="left")
    inside = (k > 0) & (k < len(edges))
    return np.where(inside, centers[np.clip(k - 1, 0, len(centers) - 1)], np.nan)


def land_grid(config: GridConfig, land_mask_fn=None) -> np.ndarray:
    """Land cell centers of the configured grid as (k, 2) [lon, lat] rows,
    sorted by lon then lat (src/data_utils.py:201-216): land is rasterized
    on a fine 0.25-degree grid and each target cell holding any land point
    is kept."""
    if land_mask_fn is None:
        from cokriging_tpu_torch.data.landmask import land_mask_fn as default_mask

        land_mask_fn = default_mask
    fine = SpatialGrid(GridConfig(config.extents, lon_res=0.25, lat_res=0.25))
    lon_g, lat_g = np.meshgrid(fine.lon_centers, fine.lat_centers)
    lon, lat = lon_g.ravel(), lat_g.ravel()
    is_land = np.asarray(land_mask_fn(lat, lon), bool)
    grid = SpatialGrid(config)
    lon_c = _cut(lon[is_land], grid.lon_bins, grid.lon_centers)
    lat_c = _cut(lat[is_land], grid.lat_bins, grid.lat_centers)
    keep = ~(np.isnan(lon_c) | np.isnan(lat_c))  # groupby drops NaN keys
    cells = np.column_stack([lon_c[keep], lat_c[keep]])
    return np.unique(cells, axis=0)  # lexicographic: lon, then lat


def set_main_coords(
    extents: Tuple = CONUS_EXTENTS, lon_res: float = 5, lat_res: float = 4
):
    """Base (unaugmented) grid centers (src/data_utils.py:304-312)."""
    grid = SpatialGrid(GridConfig(extents, lon_res=lon_res, lat_res=lat_res))
    return grid.lon_centers, grid.lat_centers


def main_coords_array(
    extents: Tuple = CONUS_EXTENTS, lon_res: float = 5, lat_res: float = 4
) -> np.ndarray:
    """All (lat, lon) base-grid center pairs as rows
    (src/data_utils.py:315-328)."""
    lon_c, lat_c = set_main_coords(extents, lon_res, lat_res)
    lon_g, lat_g = np.meshgrid(lon_c, lat_c)
    return np.column_stack([lat_g.ravel(), lon_g.ravel()])


def prediction_coords(
    extents: Tuple = CONUS_EXTENTS,
    lon_res: float = 0.5,
    lat_res: float = 0.5,
    land_mask_fn=None,
) -> np.ndarray:
    """Land-only prediction coordinates as (k, 2) [lat, lon] rows
    (src/point_prediction.py:349-355)."""
    grid = GridConfig(extents=extents, lon_res=lon_res, lat_res=lat_res)
    return land_grid(grid, land_mask_fn)[:, ::-1].copy()


# --- long-format frames (pandas, imported per call) -----------------------


def regrid(df, config: GridConfig = None):
    """Overwrite lon/lat with their grid-cell centers
    (src/data_utils.py:179-198)."""
    import pandas as pd

    if config is None:
        config = GridConfig()
    grid = SpatialGrid(config)
    grid.bounds_check(df)
    out = df.copy()
    out["lon"] = pd.cut(out.lon, grid.lon_bins, labels=grid.lon_centers).astype(float)
    out["lat"] = pd.cut(out.lat, grid.lat_bins, labels=grid.lat_centers).astype(float)
    return out


def temporal_avg(df_grid, freq: str = "1MS"):
    """Per-cell time-resampled averages at any pandas frequency: the
    monthly case is src/data_utils.py:219-227, the weekly/daily variants the
    notebooks' groupby-resample chains."""
    out = df_grid.groupby(["lon", "lat"]).resample(freq, on="time").mean()
    # lon/lat may appear both in the group index and as averaged columns
    # depending on the pandas version; keep the index copy
    out = out.drop(columns=[c for c in ("lon", "lat") if c in out.columns])
    return out.reset_index()


def monthly_avg(df_grid):
    """Per-cell monthly averages (src/data_utils.py:219-227)."""
    return temporal_avg(df_grid, "1MS")


def _land_frame(config: GridConfig, land_mask_fn=None):
    """``land_grid`` as the frame the JAX package joins on: index (lon,
    lat), one column ``land`` = 1."""
    import pandas as pd

    cells = land_grid(config, land_mask_fn)
    return pd.DataFrame({"lon": cells[:, 0], "lat": cells[:, 1], "land": 1}).set_index(
        ["lon", "lat"])


def apply_land_mask(df, config: GridConfig, land_mask_fn=None):
    """Keep rows whose grid cell is land (src/data_utils.py:230-237)."""
    return (
        df.join(_land_frame(config, land_mask_fn), on=["lon", "lat"], how="outer")
        .dropna(subset=["land"])
        .reset_index(drop=True)
        .drop(columns=["land"])
    )


def prep_gridded_df(df, config: GridConfig, aggregate: bool = True, land_mask_fn=None,
                    freq: str = "1MS"):
    """Irregular observations -> regular grid of time-averaged cells, land
    only (src/data_utils.py:240-258; ``freq`` generalizes the monthly
    default to the weekly/daily notebook variants)."""
    lon_b = config.lon_bounds
    lat_b = config.lat_bounds
    inside = (df.lon >= lon_b[0]) & (df.lon <= lon_b[1]) & (df.lat >= lat_b[0]) & (
        df.lat <= lat_b[1])
    df_grid = regrid(df.loc[inside].reset_index(drop=True), config)
    if aggregate:
        df_grid = temporal_avg(df_grid, freq)
    return apply_land_mask(df_grid, config, land_mask_fn)


# Micro-offset augmentation (src/data_utils.py:261-301): 8 lat offsets and 10
# lon offsets of the 4 x 5-degree CONUS grid pool 17 shifted copies into an
# effective 0.5-degree lattice of coarse-support averages.
_LAT_OFFSETS = np.linspace(-1.5, 2, 8)
_LON_OFFSETS = np.linspace(-2, 2.5, 10)


def augment_dataset(df, land_mask_fn=None):
    """17 offset grids (the zero offset kept once) pooled into one frame
    (src/data_utils.py:261-279)."""
    import pandas as pd

    configs = [GridConfig(CONUS_EXTENTS, lon_res=5, lat_res=4, lat_offset=d)
               for d in _LAT_OFFSETS]
    configs += [GridConfig(CONUS_EXTENTS, lon_res=5, lat_res=4, lon_offset=d)
                for d in _LON_OFFSETS[_LON_OFFSETS != 0]]
    return pd.concat([prep_gridded_df(df, c, land_mask_fn=land_mask_fn) for c in configs],
                     ignore_index=True)


def augment_dataset_pred(df, land_mask_fn=None):
    """The full 80-pair offset mesh for prediction covariates
    (src/data_utils.py:282-301)."""
    import pandas as pd

    pairs = np.array(np.meshgrid(_LAT_OFFSETS, _LON_OFFSETS)).T.reshape(-1, 2)
    frames = [
        prep_gridded_df(
            df,
            GridConfig(CONUS_EXTENTS, lon_res=5, lat_res=4, lat_offset=d[0], lon_offset=d[1]),
            land_mask_fn=land_mask_fn,
        )
        for d in pairs
    ]
    return pd.concat(frames, ignore_index=True)


def produce_climatology_conus(df, freq: str, land_mask_fn=None):
    """Domain-average climatology at the given frequency
    (src/data_utils.py:331-341)."""
    import pandas as pd

    config = GridConfig(CONUS_EXTENTS, lon_res=5, lat_res=4)
    out = prep_gridded_df(df, config, aggregate=False, land_mask_fn=land_mask_fn)
    out = out.dropna(subset=["lon", "lat"]).drop(columns=["lon", "lat"])
    return out.groupby(pd.Grouper(key="time", freq=freq)).mean().reset_index()


def to_frame(coords: np.ndarray, **kwargs):
    """Per-location variables as a frame indexed by (lon, lat) (the
    reference's to_xarray, src/data_utils.py:363-372; coords are [lat, lon]
    rows)."""
    import pandas as pd

    return pd.DataFrame({"lat": coords[:, 0], "lon": coords[:, 1], **kwargs}).set_index(
        ["lon", "lat"])
