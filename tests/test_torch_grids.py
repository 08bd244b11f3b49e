"""Port grids and land mask (numpy only) against the JAX package's
pandas/matplotlib versions: the same cells in the same order."""

import numpy as np

from cokriging_tpu.data import grids as JG, landmask as JL
from cokriging_tpu_torch.data import grids as TG, landmask as TL


def test_prediction_and_main_coords_identical():
    ref = JG.prediction_coords().values
    got = TG.prediction_coords()
    assert got.shape == ref.shape and got.shape[0] > 6000
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TG.main_coords_array(), JG.main_coords_array())
    # another resolution and offset grid through the same code
    cfg = dict(extents=JG.CONUS_EXTENTS, lon_res=1.0, lat_res=1.0)
    np.testing.assert_array_equal(
        TG.land_grid(TG.GridConfig(**cfg, lat_offset=0.25)),
        JG.land_grid(JG.GridConfig(**cfg, lat_offset=0.25)).index.to_frame().values,
    )


def test_land_mask_matches_matplotlib_on_vertices_and_edges():
    # a 0.1-degree lattice hits polygon vertices and edges exactly
    lon, lat = np.meshgrid(np.arange(-130, -60, 0.1), np.arange(18, 62, 0.1))
    np.testing.assert_array_equal(TL.land_mask_fn(lat, lon), JL.land_mask_fn(lat, lon))
