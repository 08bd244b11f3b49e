"""The port's frame layer against the JAX package on the same pandas frames:
``Field.from_dataframe`` / ``MultiField.from_dataframes`` (trend removal,
OLS, standardization, main-grid membership), the long-format grid wrangling
of ``data/grids.py``, and ``predict/postprocess.py``. Everything here is
float64 numpy on the host in both packages; the bars are 1e-12 relative
(frames of the same pandas code: exact)."""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from cokriging_tpu.data import grids as JG
from cokriging_tpu.fields import field as JF
from cokriging_tpu.predict import postprocess as JP
from cokriging_tpu_torch.data import grids as TG
from cokriging_tpu_torch.fields import field as TF
from cokriging_tpu_torch.predict import postprocess as TP

RTOL = 1e-12
TIMES = pd.date_range("2019-01-01", periods=3, freq="MS")


@pytest.fixture(scope="module")
def frame():
    """Three months x 40 cells, a temporal trend, a spatial trend on a
    covariate, per-cell measurement variances and one missing datum; the
    first 12 cells sit on the 4 x 5-degree main grid."""
    rng = np.random.default_rng(11)
    mc = JG.main_coords_array()
    on_grid = mc[rng.choice(len(mc), 12, replace=False)]
    lat = np.concatenate([on_grid[:, 0], rng.uniform(25, 50, 28)])
    lon = np.concatenate([on_grid[:, 1], rng.uniform(-120, -70, 28)])
    evi = rng.uniform(0.1, 0.6, 40)
    rows = []
    for k, t in enumerate(TIMES):
        z = 0.7 * k + 1.5 * evi + 0.01 * lat + rng.normal(scale=0.2, size=40)
        z[5 + k] = np.nan
        rows.append(pd.DataFrame({"time": t, "lat": lat, "lon": lon, "z": z,
                                  "z_var": rng.uniform(0.01, 0.02, 40), "evi": evi}))
    return pd.concat(rows, ignore_index=True)


def _assert_fields_equal(t, j):
    for name in ("coords", "values", "coords_main", "values_main", "measurement_var"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=RTOL, atol=1e-13, err_msg=name)
    for name in ("spatial_trend", "spatial_trend_main"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), rtol=RTOL, atol=1e-13)
    for name in ("temporal_trend", "spatial_mean", "scale_fact", "ols_intercept"):
        np.testing.assert_allclose(getattr(t.trend, name), getattr(j.trend, name), rtol=RTOL,
                                   atol=1e-14, err_msg=name)
    for name in ("ols_coefs", "covariate_means", "covariate_scales"):
        np.testing.assert_allclose(getattr(t.trend, name), getattr(j.trend, name), rtol=RTOL)
    assert t.trend.covariate_names == j.trend.covariate_names
    assert (t.name, t.timestamp, t.geodesic) == (j.name, j.timestamp, j.geodesic)
    assert t.values.dtype == t.coords_main.dtype == torch.float64


@pytest.mark.parametrize("covs", [["evi"], ["lon", "lat"]])
def test_field_from_dataframe_matches_jax(frame, covs):
    main = JG.main_coords_array()
    t = TF.Field.from_dataframe(frame, "z", covs, "2019-02-01", main_coords=main)
    j = JF.Field.from_dataframe(frame, "z", covs, "2019-02-01", main_coords=main)
    _assert_fields_equal(t, j)
    # one datum (an on-grid cell) is missing that month
    assert t.coords_main.shape[0] == 11 and t.size == 39
    # standardized residuals: mean 0, std 1
    v = t.values.numpy()
    assert abs(v.mean()) < 1e-12 and abs(v.std() - 1.0) < 1e-12
    pd.testing.assert_frame_equal(t.to_dataframe(main=True), j.to_dataframe(main=True))
    pd.testing.assert_frame_equal(t.to_dataframe(), j.to_dataframe())


def test_multifield_from_dataframes_timedeltas_matches_jax(frame):
    df2 = frame.rename(columns={"z": "w", "z_var": "w_var"})
    args = dict(timestamp="2019-02-01", timedeltas=[0, -1], main_coords=None)
    t = TF.MultiField.from_dataframes([frame, df2], ["z", "w"], [["evi"], ["lon", "lat"]], **args)
    j = JF.MultiField.from_dataframes([frame, df2], ["z", "w"], [["evi"], ["lon", "lat"]], **args)
    assert [f.timestamp for f in t.fields] == ["2019-02-01", "2019-01-01"]
    assert (t.timestamp, t.timedeltas, t.n_data) == (j.timestamp, j.timedeltas, j.n_data)
    for tf, jf in zip(t.fields, j.fields):
        _assert_fields_equal(tf, jf)
        assert tf.coords_main.shape == tf.coords.shape  # main_coords=None: all rows main
    f32 = t.astype(torch.float32)
    assert f32.fields[0].values.dtype == torch.float32
    assert f32.fields[0].spatial_trend.dtype == np.float64  # trend stats stay float64
    for ts, months in (("2019-02-28", -1), ("2019-01-31", 1), ("2019-03-31", -1)):
        assert TF.apply_timedelta(ts, months) == JF.apply_timedelta(ts, months)
    assert TF.apply_timedelta("2019-03-31", -1) == "2019-02-28"
    with pytest.raises(ValueError, match="same length"):
        TF.MultiField.from_dataframes([frame], ["z", "w"], [["evi"]], "2019-02-01", [0])


def test_missing_timestamp_raises_as_jax(frame):
    for mod in (TF, JF):
        with pytest.raises(ValueError, match="No data at timestamp"):
            mod.Field.from_dataframe(frame, "z", ["evi"], "2030-01-01")
    # a month present in the trend series but with every datum missing
    holes = frame.copy()
    holes.loc[holes.time == TIMES[2], "z"] = np.nan
    for mod in (TF, JF):
        with pytest.raises(ValueError, match="No data at timestamp"):
            mod.Field.from_dataframe(holes, "z", ["evi"], str(TIMES[2].date()))


def test_fit_helpers_and_coord_isin_match_jax():
    rng = np.random.default_rng(3)
    series = rng.normal(size=9)
    series[4] = np.nan
    idx = np.arange(9)
    np.testing.assert_array_equal(TF.fit_linear_trend(idx, series),
                                  JF.fit_linear_trend(idx, series))
    one = np.array([np.nan, 2.0, np.nan])  # one epoch: its mean
    np.testing.assert_array_equal(TF.fit_linear_trend(np.arange(3), one),
                                  JF.fit_linear_trend(np.arange(3), one))
    x, covs = rng.normal(size=30), rng.normal(size=(30, 2))
    for a, b in zip(TF.fit_ols(x, covs), JF.fit_ols(x, covs)):
        np.testing.assert_array_equal(a, b)
    # a grid built by linspace against one built by arange: membership by value
    main = np.column_stack([np.linspace(22.0, 58.0, 10), np.linspace(-125.0, -80.0, 10)])
    coords = np.column_stack([22.0 + 4.0 * np.arange(12), -125.0 + 5.0 * np.arange(12)])
    coords[3] += 1e-7
    got = TF._coord_isin(coords, main)
    np.testing.assert_array_equal(got, JF._coord_isin(coords, main))
    assert got.sum() == 9 and not got[3]


def _cells_frame(rng, n=600, months=2):
    rows = []
    for t in pd.date_range("2015-01-01", periods=months, freq="MS"):
        rows.append(pd.DataFrame({"time": t, "lat": rng.uniform(20, 56, n),
                                  "lon": rng.uniform(-128, -66, n), "v": rng.normal(size=n)}))
    return pd.concat(rows, ignore_index=True)


def test_grid_wrangling_matches_jax():
    rng = np.random.default_rng(5)
    df = _cells_frame(rng)
    cfg = JG.GridConfig(JG.CONUS_EXTENTS, lon_res=5, lat_res=4)
    tcfg = TG.GridConfig(TG.CONUS_EXTENTS, lon_res=5, lat_res=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pairs = [
            (TG.regrid(df, tcfg), JG.regrid(df, cfg)),
            (TG.monthly_avg(TG.regrid(df, tcfg)), JG.monthly_avg(JG.regrid(df, cfg))),
            (TG.temporal_avg(TG.regrid(df, tcfg), "1W"), JG.temporal_avg(JG.regrid(df, cfg), "1W")),
            (TG.apply_land_mask(TG.regrid(df, tcfg), tcfg), JG.apply_land_mask(JG.regrid(df, cfg), cfg)),
            (TG.prep_gridded_df(df, tcfg), JG.prep_gridded_df(df, cfg)),
            (TG.prep_gridded_df(df, tcfg, aggregate=False), JG.prep_gridded_df(df, cfg, aggregate=False)),
            (TG.produce_climatology_conus(df, "1MS"), JG.produce_climatology_conus(df, "1MS")),
        ]
    for k, (t, j) in enumerate(pairs):
        assert len(t) > 0, k
        pd.testing.assert_frame_equal(t, j, check_exact=True, obj=f"frame {k}")
    coords = np.column_stack([rng.uniform(25, 50, 5), rng.uniform(-120, -70, 5)])
    pd.testing.assert_frame_equal(TG.to_frame(coords, pred=np.arange(5.0)),
                                  JG.to_frame(coords, pred=np.arange(5.0)))


def test_bounds_check_warns_as_jax():
    df = pd.DataFrame({"lon": [-140.0, -100.0], "lat": [30.0, 40.0], "v": [1.0, 2.0]})
    grid = TG.SpatialGrid(TG.GridConfig(TG.CONUS_EXTENTS, lon_res=5, lat_res=4))
    with pytest.warns(UserWarning, match="not within grid extents"):
        grid.bounds_check(df)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        grid.bounds_check(df.iloc[1:])


def _half_land(lat, lon):
    """A cheap land mask (the 97 offset grids below each rasterize one)."""
    return (np.asarray(lat) > 33.0) | (np.asarray(lon) < -100.0)


def test_augment_dataset_matches_jax(monkeypatch):
    """The 17-offset augmentation, and the prediction mesh (80 offset pairs
    in both packages; here both run it over 3 x 2 of them, the same code at
    a sixth of the cost), on a month of sparse observations."""
    np.testing.assert_array_equal(TG._LAT_OFFSETS, JG._LAT_OFFSETS)
    np.testing.assert_array_equal(TG._LON_OFFSETS, JG._LON_OFFSETS)
    df = _cells_frame(np.random.default_rng(9), n=300, months=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t, j = (G.augment_dataset(df, land_mask_fn=_half_land) for G in (TG, JG))
        for G in (TG, JG):
            monkeypatch.setattr(G, "_LAT_OFFSETS", np.array([-1.5, 0.0, 2.0]))
            monkeypatch.setattr(G, "_LON_OFFSETS", np.array([0.0, 2.5]))
        tp, jp = (G.augment_dataset_pred(df, land_mask_fn=_half_land) for G in (TG, JG))
    pd.testing.assert_frame_equal(t, j, check_exact=True)
    pd.testing.assert_frame_equal(tp, jp, check_exact=True)
    assert len(t) > 0 and len(tp) > 0


def test_postprocess_with_covariates_merge_drops_rows(frame):
    """postprocess(pred = values) reproduces the data at the data locations;
    prediction rows without covariates are dropped, as in the JAX package."""
    ts = "2019-02-01"
    t = TF.Field.from_dataframe(frame, "z", ["evi"], ts)
    j = JF.Field.from_dataframe(frame, "z", ["evi"], ts)
    sel = frame[frame.time == ts].dropna(subset=["z"]).reset_index(drop=True)
    df_pred = pd.DataFrame({"lat": sel["lat"], "lon": sel["lon"], "pred": t.values.numpy(),
                            "pred_err": 0.5})
    covariates = sel[["lat", "lon", "evi"]].iloc[3:].reset_index(drop=True)
    got = TP.postprocess_predictions(df_pred, t, covariates)
    want = JP.postprocess_predictions(df_pred, j, covariates)
    assert len(got) == len(sel) - 3
    pd.testing.assert_frame_equal(got, want, rtol=RTOL)
    np.testing.assert_allclose(got["pred"].values, sel["z"].values[3:], rtol=1e-10)
    # without a covariates frame the coordinates must carry the covariates
    with pytest.raises(ValueError, match="lacks covariate"):
        TP.postprocess_predictions(df_pred, t)
    # a field without trend statistics passes through
    bare = TF.Field.from_arrays(np.zeros((2, 2)), np.zeros(2))
    pd.testing.assert_frame_equal(TP.postprocess_predictions(df_pred, bare), df_pred)


def test_inverse_transform_and_loocv_frame_match_jax(frame):
    ts = "2019-02-01"
    main = JG.main_coords_array()
    t = TF.Field.from_dataframe(frame, "z", ["lon", "lat"], ts, main_coords=main)
    j = JF.Field.from_dataframe(frame, "z", ["lon", "lat"], ts, main_coords=main)
    recon = TP.inverse_transform_data(t)
    np.testing.assert_allclose(recon, JP.inverse_transform_data(j), rtol=RTOL)
    sel = frame[frame.time == ts].dropna(subset=["z"])
    on_main = TF._coord_isin(sel[["lat", "lon"]].values, main)
    np.testing.assert_allclose(recon, sel["z"].values[on_main], rtol=1e-10)
    rng = np.random.default_rng(2)
    n_main = t.coords_main.shape[0]
    pred, err = rng.normal(size=n_main), rng.uniform(0.1, 1.0, n_main)
    for post in (True, False):
        got = TP.loocv_frame(t, True, pred, err, post)
        want = JP.loocv_frame(j, True, pred, err, post)
        pd.testing.assert_frame_equal(got, want, rtol=RTOL)
        np.testing.assert_allclose(got["residual"], got["data"] - got["pred"], rtol=0, atol=0)
