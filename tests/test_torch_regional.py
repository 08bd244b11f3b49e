"""The port's regional drivers (``stats/regional.py``: pandas on the host,
the statistics of ``stats/spacetime.py`` on the device) against the JAX
package's, on the CPU in float64: tests/test_regional.py's two-cell monthly
frame (XCO2 follows SIF by 2 months in the north cell and 1 in the south)
with NaN holes, and a small TransCom-like region map. Frames equal, numbers
within 1e-12 relative."""

import numpy as np
import pandas as pd
import pytest
import torch

from cokriging_tpu import stats as JS
from cokriging_tpu_torch import stats as TS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def monthly_frame():
    rng = np.random.default_rng(3)
    n_t = 48
    times = pd.date_range("2016-01-01", periods=n_t, freq="MS")
    rows = []
    for lat, lon, lag in [(42.5, -102.5, 2), (-37.5, 147.5, 1), (12.5, 17.5, 1)]:
        anom = rng.normal(size=n_t)
        for t in range(1, n_t):
            anom[t] = 0.5 * anom[t - 1] + anom[t]
        sif = 0.7 + 0.3 * anom
        xco2 = np.full(n_t, 405.0)
        xco2[lag:] = 405.0 - 0.9 * anom[:-lag]
        sif[rng.uniform(size=n_t) < 0.1] = np.nan
        rows.append(pd.DataFrame({"time": times, "lat": lat, "lon": lon, "sif": sif,
                                  "xco2": xco2}))
    return pd.concat(rows, ignore_index=True)


def _frames(t, j):
    assert list(t.columns) == list(j.columns)
    for col in j.columns:
        if pd.api.types.is_numeric_dtype(j[col]):
            np.testing.assert_allclose(t[col].to_numpy(np.float64), j[col].to_numpy(np.float64),
                                       rtol=1e-12, atol=1e-14, equal_nan=True, err_msg=col)
        else:
            assert list(t[col]) == list(j[col]), col


def test_cubes_and_gridded_stats_match_jax(monthly_frame):
    (ct, lat_t, lon_t, tm_t) = TS.to_cubes(monthly_frame, ["sif", "xco2"])
    (cj, lat_j, lon_j, tm_j) = JS.to_cubes(monthly_frame, ["sif", "xco2"])
    for a, b in ((lat_t, lat_j), (lon_t, lon_j), (tm_t, tm_j)):
        np.testing.assert_array_equal(a, b)
    for k in cj:
        np.testing.assert_array_equal(ct[k], cj[k])
    got, _, _ = TS.gridded_stats(monthly_frame, lags=(1, 2), tau=20, device="cpu")
    want, _, _ = JS.gridded_stats(monthly_frame, lags=(1, 2), tau=20)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("grouper", ["hemisphere", "lat_band"])
def test_regional_monthly_and_stats_match_jax(monthly_frame, grouper):
    label = {"hemisphere": (TS.hemisphere_labels, JS.hemisphere_labels),
             "lat_band": (TS.lat_band_labels, JS.lat_band_labels)}[grouper]
    lt, lj = label[0](monthly_frame), label[1](monthly_frame)
    pd.testing.assert_series_equal(lt, lj)
    mt = TS.regional_monthly(monthly_frame, lt)
    mj = JS.regional_monthly(monthly_frame, lj)
    pd.testing.assert_frame_equal(mt, mj)
    _frames(TS.regional_stats(mt, grouper, lags=(0, 1, 2), device="cpu"),
            JS.regional_stats(mj, grouper, lags=(0, 1, 2)))


def test_transcom_mapping_and_grid_match_jax(monthly_frame):
    cells = pd.DataFrame({"lat": [42.5, -37.5, 12.5, 12.5], "lon": [-102.5, 147.5, 17.5, 18.5],
                          "region": [2.0, 9.0, 7.0, 7.0]})
    tt = TS.map_transcom(monthly_frame, cells)
    tj = JS.map_transcom(monthly_frame, cells)
    pd.testing.assert_frame_equal(tt, tj)
    mt = TS.regional_monthly(tt, "region")
    st = TS.regional_stats(mt, "region", lags=(1, 2), tau=10, device="cpu")
    sj = JS.regional_stats(JS.regional_monthly(tj, "region"), "region", lags=(1, 2), tau=10)
    _frames(st, sj)
    pd.testing.assert_frame_equal(TS.stats_to_grid(st, cells), JS.stats_to_grid(sj, cells),
                                  check_exact=False, rtol=1e-12)
