"""The port's conditional simulation (``JointPredictor.sample``) against the
JAX package's, on the CPU in float64. ``eigh`` fixes its eigenvectors only up
to sign (and rotation in the posterior's near-zero cluster), so the samples
are not unique given the draws: the port is held to the JAX package's
prediction, error and posterior covariance, to root root^T equal to that
covariance, and its draws by their moments. The draws honor the data in the
noise-free limit and come back aligned with the postprocessed frame."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams, MultivariateMatern as JMod
from cokriging_tpu.predict import JointPredictor as JJoint
from cokriging_tpu.predict import joint as JJ
from cokriging_tpu.sim import BivariateRandomField as JField, CartesianGrid as JGrid
from cokriging_tpu_torch.cov.matern import MultivariateMatern
from cokriging_tpu_torch.fields.field import Field, MultiField, TrendStats
from cokriging_tpu_torch.predict import JointPredictor
from cokriging_tpu_torch.predict import joint as TJ
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

SIM_FLAT = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.0, 0.0, -0.6]


@pytest.fixture(scope="module")
def setup():
    """tests/test_conditional.py's cofield and samples, drawn by the JAX
    package, in both packages' containers."""
    jmod = JMod(params=JParams.from_flat(jnp.asarray(SIM_FLAT)))
    grid = JGrid(xcount=25, ycount=25)
    rf = JField(jmod, grid, seed=3)
    samples = rf.sample(size=80, epsilon=[0.0, 0.0], seed=5)
    jmf = rf.to_fields(samples)
    tmf = MultiField(fields=[Field.from_arrays(s[["x", "y"]].values, s[f"Z{k}"].values, f"Z{k}")
                             for k, s in enumerate(samples)])
    tmod = MultivariateMatern(params=params_from_numpy(np.array(SIM_FLAT)))
    taken = {(round(x, 12), round(y, 12)) for s in samples for x, y in s[["x", "y"]].values}
    pts = grid.coords.values
    held = pts[np.array([(round(x, 12), round(y, 12)) not in taken for x, y in pts])]
    return jmod, jmf, tmod, tmf, held


def test_posterior_matches_jax_and_root_reproduces_it(setup):
    jmod, jmf, tmod, tmf, held = setup
    pc = held[::17]
    jc = tuple(f.coords_main for f in jmf.fields)
    jv = tuple(f.values_main for f in jmf.fields)
    joint_cov, pred_cross, pred_cov = JJ._joint_system(jmod.params, jc, jnp.asarray(pc), 0, False)
    w = JJ._refined_posdef_solve(joint_cov, pred_cross)
    post_j = np.asarray(pred_cov - w.T @ pred_cross)
    post_j = 0.5 * (post_j + post_j.T)
    tc = tuple(f.coords_main for f in tmf.fields)
    tv = tuple(f.values_main for f in tmf.fields)
    pred, err, post, root = TJ._posterior(tmod.params, tc, tv, torch.as_tensor(pc), 0, False)
    np.testing.assert_allclose(post.numpy(), post_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose((root @ root.T).numpy(), post_j, rtol=0, atol=1e-10)
    j_pred, j_err, _ = JJ._conditional_sample_core(jmod.params, jc, jv, jnp.asarray(pc),
                                                   jax.random.PRNGKey(0), 0,
                                                   False, (80, 80), 3)
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(err.numpy(), np.asarray(j_err), rtol=1e-8, atol=1e-12)


def test_sample_moments_match_prediction(setup):
    jmod, jmf, tmod, tmf, held = setup
    pc = held[::17]
    jp = JointPredictor(tmod, tmf, device="cpu")
    base = jp(0, pc)
    out, draws = jp.sample(0, pc, n_samples=4000, seed=1)
    j_df, _ = JJoint(jmod, jmf).sample(0, pc, n_samples=2, seed=1, postprocess=False)
    assert draws.shape == (4000, len(pc)) and draws.dtype == np.float64
    np.testing.assert_allclose(out.pred, base.pred, rtol=1e-8)
    np.testing.assert_allclose(out.pred_err, base.pred_err, rtol=1e-8)
    np.testing.assert_allclose(out.pred, j_df["pred"], rtol=1e-8)
    np.testing.assert_allclose(out.pred_err, j_df["pred_err"], rtol=1e-8)
    se_mean = base.pred_err / np.sqrt(4000)
    assert np.all(np.abs(draws.mean(axis=0) - base.pred) < 5 * se_mean)
    np.testing.assert_allclose(draws.std(axis=0), base.pred_err, rtol=0.12)
    # the same seed, the same draws; another seed, others
    np.testing.assert_array_equal(jp.sample(0, pc, n_samples=5, seed=3)[1],
                                  jp.sample(0, pc, n_samples=5, seed=3)[1])
    assert not np.array_equal(jp.sample(0, pc, n_samples=5, seed=3)[1],
                              jp.sample(0, pc, n_samples=5, seed=4)[1])


def test_samples_interpolate_data_and_errors_are_correlated(setup):
    _, _, tmod, tmf, held = setup
    jp = JointPredictor(tmod, tmf, device="cpu")
    # nugget 0 and epsilon 0: the posterior at a datum is a point mass on it
    data_coords = tmf.fields[0].coords_main.numpy()[:20]
    _, draws = jp.sample(0, data_coords, n_samples=50, seed=2)
    assert np.max(np.abs(draws - tmf.fields[0].values_main.numpy()[None, :20])) < 1e-4
    pair = held[10:12]
    assert np.linalg.norm(pair[0] - pair[1]) < 0.1
    _, draws = jp.sample(0, pair, n_samples=3000, seed=4)
    assert np.corrcoef(draws[:, 0], draws[:, 1])[0, 1] > 0.5


def test_postprocessed_samples_align_with_frame(setup):
    """With a trend and a covariate frame that lacks some prediction rows,
    the realizations follow the frame's rows and its affine back-transform
    (tests/test_conditional.py:84, here with the back-transform active)."""
    _, _, tmod, tmf, held = setup
    trend = TrendStats(temporal_trend=0.3, spatial_mean=2.0, scale_fact=1.7, ols_intercept=0.0,
                       ols_coefs=np.array([0.5, -0.25]), covariate_means=np.array([0.5, 0.5]),
                       covariate_scales=np.array([0.3, 0.3]), covariate_names=("cx", "cy"))
    f0 = dataclasses.replace(tmf.fields[0], trend=trend)
    mf = MultiField(fields=[f0, tmf.fields[1]])
    pc = held[::23]
    cov = {"x": pc[:, 0], "y": pc[:, 1], "cx": pc[:, 0], "cy": pc[:, 1]}
    covariates = pd.DataFrame(cov).iloc[2:]  # the first two rows dropped
    jp = JointPredictor(tmod, mf, covariates=covariates, device="cpu")
    frame, draws = jp.sample(0, pc, n_samples=2000, seed=6, postprocess=True)
    raw, draws_std = jp.sample(0, pc, n_samples=2000, seed=6)
    assert len(frame) == len(pc) - 2 and draws.shape == (2000, len(frame))
    np.testing.assert_array_equal(frame[["x", "y"]].values, pc[2:])
    surface = trend.predict_ols(pc[2:])
    np.testing.assert_allclose(frame["pred"], raw.pred[2:] * 1.7 + 2.0 + surface + 0.3,
                               rtol=1e-12)
    np.testing.assert_allclose(draws, draws_std[:, 2:] * 1.7 + (2.0 + surface + 0.3)[None],
                               rtol=1e-12)
    se_mean = frame["pred_err"].values / np.sqrt(2000)
    assert np.all(np.abs(draws.mean(axis=0) - frame["pred"].values) < 5 * se_mean)
    np.testing.assert_allclose(draws.std(axis=0), draws_std[:, 2:].std(axis=0) * 1.7, rtol=1e-6)


def test_default_device_is_the_card(setup, monkeypatch):
    _, _, tmod, tmf, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JointPredictor(tmod, tmf).sample(0, np.zeros((1, 2)))
