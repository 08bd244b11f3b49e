"""LOOCV and data-scale predictions in the port's three predictors against
the JAX package, on the same frames (fields with trend statistics), on the
CPU in float64: ``LocalPredictor`` (materialized, direct and kd paths; the
d > 0 withholding, also at the float32 zero snap), ``JointPredictor`` and
``IterativeJointPredictor`` (against the dense port and the JAX package,
with a ragged last chunk), each with ``postprocess=True`` and with a
covariates frame."""

import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cokriging_tpu.cov import MultivariateMatern as JMod
from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.fields.field import MultiField as JMultiField
from cokriging_tpu.predict import IterativeJointPredictor as JIterative
from cokriging_tpu.predict import JointPredictor as JJoint
from cokriging_tpu.predict import LocalPredictor as JLocal
from cokriging_tpu_torch.cov.matern import MultivariateMatern
from cokriging_tpu_torch.fields.field import MultiField
from cokriging_tpu_torch.predict import IterativeJointPredictor, JointPredictor, LocalPredictor
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

# a valid model with nuggets: every local and joint system is well posed
FLAT = np.array([1.0, 0.9, 1.3, 1.2, 1.1, 450.0, 500.0, 550.0, 0.08, 0.1, -0.5])
MAX_DIST = 600.0
TIMES = pd.date_range("2019-01-01", periods=3, freq="MS")


def _elev(lat, lon):
    return 0.5 * np.sin(np.deg2rad(lat * 5.0)) * np.cos(np.deg2rad(lon * 3.0))


def _frames(n, seed):
    """Two processes' long-format frames, three months of n cells in a
    20 x 15-degree box: a smooth signal, a temporal and a spatial trend (on
    lon/lat for the first process, on a covariate ``elev`` for the
    second)."""
    rng = np.random.default_rng(seed)
    out = []
    for name, sign in (("xco2", 1.0), ("sif", -0.7)):
        lat, lon = rng.uniform(30.0, 45.0, n), rng.uniform(-110.0, -90.0, n)
        s = np.sin(np.deg2rad(lat) * 8.0) + 0.5 * np.cos(np.deg2rad(lon) * 6.0)
        rows = [pd.DataFrame({"time": t, "lat": lat, "lon": lon,
                              name: sign * s + 0.02 * lat + _elev(lat, lon) + 0.1 * k
                              + rng.normal(scale=0.3, size=n),
                              f"{name}_var": 0.01, "elev": _elev(lat, lon)})
                for k, t in enumerate(TIMES)]
        out.append(pd.concat(rows, ignore_index=True))
    return out


def _fields(dfs):
    args = (dfs, ["xco2", "sif"], [["lon", "lat"], ["elev"]], "2019-02-01", [0, 0])
    return MultiField.from_dataframes(*args), JMultiField.from_dataframes(*args)


def _models(flat=FLAT):
    return (MultivariateMatern(params=params_from_numpy(flat)),
            JMod(params=JParams.from_flat(jnp.asarray(flat))))


@pytest.fixture(scope="module")
def month():
    return _fields(_frames(60, 5))


@pytest.fixture(scope="module")
def small():
    return _fields(_frames(35, 6))


def _assert_frames(got, want, rtol=1e-10, atol=1e-12):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(), rtol=rtol, atol=atol,
                                   err_msg=c)


LOCAL_KINDS = {
    "materialized": {},
    "direct": dict(materialize_cov=False, neighbor_method="device"),
    "kd": dict(materialize_cov=False, neighbor_method="kd"),
}


@pytest.mark.parametrize("kind,i", [("materialized", 0), ("direct", 1), ("kd", 0)])
def test_local_loocv_matches_jax(month, kind, i):
    """One process per path: each (path, process) is one more compiled JAX
    program."""
    (tmf, jmf), (tmod, jmod) = month, _models()
    kw = LOCAL_KINDS[kind]
    lp = LocalPredictor(tmod, tmf, device="cpu", **kw)
    jlp = JLocal(jmod, jmf, **kw)
    if True:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jlp.cross_validation(i, max_dist=MAX_DIST, postprocess=False)
            want_pp = jlp.cross_validation(i, max_dist=MAX_DIST, postprocess=True)
        got = lp.cross_validation(i, max_dist=MAX_DIST, postprocess=False)
        np.testing.assert_allclose(got.pred, want["pred"], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got.pred_err, want["pred_err"], rtol=1e-10, atol=1e-12)
        assert np.isfinite(got.pred).all()
        _assert_frames(lp.cross_validation(i, max_dist=MAX_DIST, postprocess=True), want_pp)


def test_local_loocv_withholds_only_the_self_datum(month):
    """The self-datum leaves every neighborhood: each LOOCV neighborhood is
    the prediction's at the same location less one lane (the device search
    and the kd-tree search; the direct path shares the device search)."""
    tmf, _ = month
    mod, _ = _models()
    coords = tmf.fields[0].coords_main.numpy()
    for kw in (LOCAL_KINDS["materialized"], LOCAL_KINDS["kd"]):
        lp = LocalPredictor(mod, tmf, device="cpu", **kw)
        full = lp(0, coords, max_dist=MAX_DIST, postprocess=False)
        cv = lp.cross_validation(0, max_dist=MAX_DIST, postprocess=False)
        np.testing.assert_array_equal(cv.n_neighbors, full.n_neighbors - 1)
        # at its own location the full predictor reproduces the datum up to the nugget
        assert not np.allclose(cv.pred, full.pred)


@pytest.mark.parametrize("dtype,offset_deg,withheld", [
    (np.float64, 1e-4, 1),
    (np.float32, 1e-3, 1),
    # 1e-4 degrees is 11 m, below the float32 geodesic zero snap (20 m): the
    # close neighbor reads as the datum itself and leaves with it
    (np.float32, 1e-4, 2),
])
def test_local_loocv_zero_snap(dtype, offset_deg, withheld):
    """Two data of one process ``offset_deg`` apart: LOOCV at the first
    withholds ``withheld`` lanes. At the float32 snap both packages withhold
    the pair (their predictions there agree, and differ from one that keeps
    the near copy); any other neighborhood holding both reads a singular
    system in float32, in either package."""
    dfs = _frames(40, 8)
    first, second = dfs[0].index % 40 == 0, dfs[0].index % 40 == 1
    dfs[0].loc[second, "lat"] = dfs[0].loc[first, "lat"].to_numpy() + offset_deg
    dfs[0].loc[second, "lon"] = dfs[0].loc[first, "lon"].to_numpy()
    tmf, jmf = _fields(dfs)
    tmf = tmf.astype(getattr(torch, np.dtype(dtype).name))
    tmod, jmod = _models(FLAT.astype(dtype))
    lp = LocalPredictor(tmod, tmf, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cv = lp.cross_validation(0, max_dist=MAX_DIST, postprocess=False)
        full = lp(0, tmf.fields[0].coords_main.numpy(), max_dist=MAX_DIST, postprocess=False)
    assert cv.n_neighbors[0] == full.n_neighbors[0] - withheld
    assert cv.n_neighbors[2] == full.n_neighbors[2] - 1
    assert np.isfinite(cv.pred[0])
    if withheld == 2:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = JLocal(jmod, jmf.astype(dtype)).cross_validation(
                0, max_dist=MAX_DIST, postprocess=False)
        np.testing.assert_allclose(cv.pred[0], want["pred"].iloc[0], rtol=2e-4, atol=2e-4)
        z0 = float(tmf.fields[0].values_main[0])
        assert abs(cv.pred[0] - z0) > 10 * abs(cv.pred[0] - want["pred"].iloc[0])


def test_local_postprocess_and_covariates_match_jax(month):
    """Process 1's trend is on ``elev``: it postprocesses through a
    covariates frame, which here lacks five of the locations, so those rows
    are dropped; without one it cannot."""
    (tmf, jmf), (tmod, jmod) = month, _models()
    rng = np.random.default_rng(1)
    pc = pd.DataFrame({"lat": rng.uniform(32.0, 43.0, 25), "lon": rng.uniform(-108.0, -92.0, 25)})
    cov = pc.iloc[5:].assign(elev=lambda d: _elev(d.lat, d.lon))
    got = LocalPredictor(tmod, tmf, cov, device="cpu")(1, pc, max_dist=MAX_DIST,
                                                         postprocess=True)
    want = JLocal(jmod, jmf, cov)(1, pc, max_dist=MAX_DIST, postprocess=True)
    assert len(got) == 20
    _assert_frames(got, want)
    with pytest.raises(ValueError, match="lacks covariate"):
        LocalPredictor(tmod, tmf, device="cpu")(1, pc, max_dist=MAX_DIST, postprocess=True)
    raw = LocalPredictor(tmod, tmf, device="cpu")(1, pc.to_numpy(), postprocess=False)
    assert isinstance(raw.pred, np.ndarray)


def test_joint_loocv_and_postprocess_match_jax(month):
    """The dense LOOCV frame of process 0, and process 0's predictions on
    the data scale (its trend on the coordinates, which the prediction frame
    carries) and process 1's through a covariates frame."""
    (tmf, jmf), (tmod, jmod) = month, _models()
    jp, jjp = JointPredictor(tmod, tmf, device="cpu"), JJoint(jmod, jmf)
    got = jp.cross_validation(0, postprocess=True)
    _assert_frames(got, jjp.cross_validation(0, postprocess=True))
    raw = jp.cross_validation(0, postprocess=False)
    np.testing.assert_allclose(got["pred_err"], raw.pred_err * tmf.fields[0].trend.scale_fact,
                               rtol=1e-14)
    pc = pd.DataFrame(np.random.default_rng(2).uniform([32.0, -108.0], [43.0, -92.0], (9, 2)),
                      columns=["lat", "lon"])
    cov = pc.iloc[2:].assign(elev=lambda d: _elev(d.lat, d.lon))
    _assert_frames(JointPredictor(tmod, tmf, cov, device="cpu")(1, pc, postprocess=True),
                   JJoint(jmod, jmf, cov)(1, pc, postprocess=True))
    pp0 = jp(0, pc, postprocess=True)
    raw0 = jp(0, pc, postprocess=False)
    trend = tmf.fields[0].trend
    np.testing.assert_allclose(
        pp0["pred"], raw0.pred * trend.scale_fact + trend.spatial_mean
        + trend.predict_ols(pc[["lon", "lat"]].to_numpy()) + trend.temporal_trend, rtol=1e-13)


def test_iterative_loocv_matches_dense_and_jax(small):
    """CG LOOCV of process 1 in chunks of 32 over 35 rows (a ragged last
    chunk of 3) to tol 1e-10: equal to the dense identity (rtol 1e-6 / atol
    1e-8, the bar of tests/test_iterative.py) and to the JAX package's CG
    LOOCV, whose last chunk is padded with repeated columns."""
    (tmf, jmf), (tmod, jmod) = small, _models()
    ijp = IterativeJointPredictor(tmod, tmf, block=32, rhs_batch=32, tol=1e-10, maxiter=500,
                                  device="cpu")
    dense = JointPredictor(tmod, tmf, device="cpu")
    got = ijp.cross_validation(1, postprocess=True)
    assert len(ijp.last_diagnostics) == 2 and max(k for k, _ in ijp.last_diagnostics) < 500
    _assert_frames(got, dense.cross_validation(1, postprocess=True), rtol=1e-6, atol=1e-8)
    want = JIterative(jmod, jmf, block=32, rhs_batch=32, tol=1e-10, maxiter=500
                      ).cross_validation(1, postprocess=True)
    _assert_frames(got, want, rtol=1e-6, atol=1e-8)
    # predictions on the data scale (the mean solve only)
    pc = np.random.default_rng(3).uniform([32.0, -108.0], [43.0, -92.0], (5, 2))
    mean = ijp(0, pc, postprocess=True, compute_err=False)
    assert mean["pred_err"].isna().all()
    np.testing.assert_allclose(mean["pred"], dense(0, pc, postprocess=True)["pred"], rtol=1e-6,
                               atol=1e-8)


def test_iterative_loocv_warns_when_cg_stops_early(small):
    tmf, _ = small
    tmod, _ = _models()
    ijp = IterativeJointPredictor(tmod, tmf, block=32, rhs_batch=64, tol=1e-10, maxiter=2,
                                  device="cpu")
    with pytest.warns(UserWarning, match="iterative LOOCV solves did not converge"):
        ijp.cross_validation(0, postprocess=False)
    assert ijp.last_diagnostics[0][0] == 2
