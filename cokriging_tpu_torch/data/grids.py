"""Regular lat/lon grids: the land cells to predict at and the main grid.

Counterpart of the grid half of ``cokriging_tpu/data/grids.py``, in numpy
only: ``GridConfig``, ``SpatialGrid``, ``main_coords_array`` and
``prediction_coords`` (src/data_utils.py:122-216, 304-328;
src/point_prediction.py:349-355). Where the JAX package goes through
pandas, this module reproduces it: ``pd.cut``'s right-closed binning
(values on the lowest edge fall outside) and the (lon, lat) key order of a
pandas groupby, so both packages return the same cells in the same order.
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
