"""The port's whole slice against the JAX package: bench.py's run_pipeline
(variograms -> moment init -> Adam WLS fit -> local cokriging at land cells)
at 400 observations per process, on the CPU in float64."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MultivariateMatern as JMM
from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.estimate import empirical as JE, wls as JW
from cokriging_tpu.fields.field import Field as JF, MultiField as JMF
from cokriging_tpu.predict import LocalPredictor as JLP
from cokriging_tpu_torch.cov.matern import MultivariateMatern as TMM
from cokriging_tpu_torch.data.grids import prediction_coords
from cokriging_tpu_torch.estimate import empirical as TE, wls as TW
from cokriging_tpu_torch.fields.field import Field as TF, MultiField as TMF
from cokriging_tpu_torch.kernels.linalg import spd_solve
from cokriging_tpu_torch.predict.local import LocalPredictor as TLP
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

N = 400
MAXITER = 50
# Off the half-integer orders: the reference's CF2 dK/dnu jumps by up to ~2%
# across nu = 1.5 (the moment initializer's start), and which side each
# package's box transform lands on is decided by the last ulp of log1p.
NU_START = (1.4, 1.3, 1.2)


def _inputs():
    """bench.py's synthetic month (bench.py:87-120) at N per process."""
    rng = np.random.default_rng(0)
    out = []
    for scale in (1.0, -0.6):
        lat, lon = rng.uniform(24.0, 50.0, N), rng.uniform(-124.0, -67.0, N)
        s = (np.sin(np.deg2rad(lat) * 6.0) + 0.5 * np.cos(np.deg2rad(lon) * 4.0)
             + 0.3 * np.sin(np.deg2rad(lat * 2 + lon)))
        out.append((np.column_stack([lat, lon]), s, scale))
    nrng = np.random.default_rng(1)
    res = []
    for c, s, scale in out:
        v = scale * s + nrng.normal(scale=0.4, size=N)
        res += [c, (v - v.mean()) / v.std()]
    return res


def _multifield(F, MF, c1, v1, c2, v2):
    sub = 2
    f1 = F.from_arrays(c1[::sub], v1[::sub], "Z0")
    f1.geodesic = True
    f2 = F.from_arrays(c2[::sub], v2[::sub], "Z1")
    f2.geodesic = True
    return MF(fields=[f1, f2])


@pytest.fixture(scope="module")
def runs():
    c1, v1, c2, v2 = _inputs()
    pc = prediction_coords()[::8]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # the JAX package (bench.py run_pipeline)
        cfg = JE.VarioConfig(max_dist=3_000.0, n_bins=15, geodesic=True)
        pairs, centers, means, counts = JE.empirical_variograms_device([c1, c2], [v1, v2], cfg)
        est = JE.EmpiricalVariogram(None, cfg, None, None, pairs, centers, means, counts)
        x0 = np.asarray(JW.moment_init(est).to_flat()).copy()
        x0[2:5] = NU_START
        jp, _ = JW.fit_wls(est, init=JParams.from_flat(jnp.asarray(x0)), method="adam",
                           maxiter=MAXITER, theoretical=False)
        jout = JLP(JMM(params=jp), _multifield(JF, JMF, c1, v1, c2, v2))(
            0, pc, max_dist=1_000.0, postprocess=False)
        # the port, same path
        tcfg = TE.VarioConfig(max_dist=3_000.0, n_bins=15, geodesic=True)
        tpairs, tcenters, tmeans, tcounts = TE.empirical_variograms_device(
            [c1, c2], [v1, v2], tcfg, device="cpu")
        test = TE.EmpiricalVariogram(tcfg, tpairs, tcenters, tmeans, tcounts)
        init = TW.moment_init(test)
        flat = init.to_flat().clone()
        flat[2:5] = torch.tensor(NU_START, dtype=flat.dtype)
        tp, _ = TW.fit_wls(test, init=init.with_flat(flat), method="adam",
                           maxiter=MAXITER, device="cpu")
        mf = _multifield(TF, TMF, c1, v1, c2, v2)
        tout = TLP(TMM(params=tp), mf, device="cpu")(0, pc, max_dist=1_000.0)
        # the port's predictor from the JAX package's fitted parameters
        tout_jp = TLP(TMM(params=params_from_numpy(np.asarray(jp.to_flat()))), mf,
                      device="cpu")(0, pc, max_dist=1_000.0)
    return dict(jp=np.asarray(jp.to_flat()), tp=tp.to_flat().numpy(), jout=jout,
                tout=tout, tout_jp=tout_jp, counts=(np.asarray(counts), tcounts))


def test_local_predictor_matches_jax(runs):
    ref, got = runs["jout"], runs["tout_jp"]
    np.testing.assert_array_equal(got.coords, ref[["lat", "lon"]].values)
    np.testing.assert_allclose(got.pred, ref["pred"].values, atol=1e-8, equal_nan=True)
    np.testing.assert_allclose(got.pred_err, ref["pred_err"].values, atol=1e-8, equal_nan=True)
    assert np.isfinite(got.pred).mean() > 0.95
    np.testing.assert_allclose(got.to_dataframe()["pred"].values, got.pred)


def test_whole_slice_matches_jax(runs):
    np.testing.assert_array_equal(*runs["counts"])
    np.testing.assert_allclose(runs["tp"], runs["jp"], rtol=1e-6)
    ref, got = runs["jout"], runs["tout"]
    np.testing.assert_allclose(got.pred, ref["pred"].values, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got.pred_err, ref["pred_err"].values, atol=1e-6, equal_nan=True)


def test_spd_solve_marks_failed_lanes():
    a = torch.eye(4, dtype=torch.float64).repeat(3, 1, 1) * 2.0
    a[1, 2, 2] = -1.0  # not positive definite
    c = torch.ones(3, 4, dtype=torch.float64)
    x, ok = spd_solve(a, c)
    assert ok.tolist() == [True, False, True]
    assert torch.isnan(x[1]).all()
    np.testing.assert_allclose(x[[0, 2]].numpy(), 0.5)
