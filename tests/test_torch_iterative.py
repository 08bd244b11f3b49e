"""The port's matrix-free joint cokriging (``predict/iterative.py``): the
tiled matvec against the dense joint covariance, and the CG predictor
against the port's dense ``JointPredictor`` and the JAX package's
``IterativeJointPredictor`` (the bars of ``tests/test_iterative.py``), on the
CPU in float64."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams
from cokriging_tpu.cov import MultivariateMatern as JMod
from cokriging_tpu.fields.field import Field as JField
from cokriging_tpu.fields.field import MultiField as JMultiField
from cokriging_tpu.predict import IterativeJointPredictor as JIterative
from cokriging_tpu_torch.cov.matern import MultivariateMatern, block_covariance
from cokriging_tpu_torch.estimate.nll import joint_distance_blocks
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.kernels import cuda_ops as K
from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor, _tiled_rows_matvec
from cokriging_tpu_torch.predict.joint import JointPredictor
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

# well conditioned: a moderate nugget keeps the CG iteration counts small
FLAT = np.array([1.0, 1.3, 1.5, 1.2, 0.8, 0.25, 0.2, 0.3, 0.05, 0.08, -0.5])


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    coords = [rng.uniform(0.0, 1.0, (30, 2)), rng.uniform(0.0, 1.0, (37, 2))]
    values = [rng.normal(size=30), rng.normal(size=37)]
    pc = np.random.default_rng(3).uniform(0.1, 0.9, (13, 2))
    return coords, values, pc


def _mf(coords, values, cls_f=Field, cls_mf=MultiField):
    return cls_mf(fields=[cls_f.from_arrays(c, v, f"Z{k}")
                          for k, (c, v) in enumerate(zip(coords, values))])


def test_matvec_matches_dense(setup, monkeypatch):
    """The tiled matvec equals the dense joint covariance times V; 67 rows
    in tiles of 16 leave a ragged last tile, one pairs evaluation each."""
    coords, _, _ = setup
    params = params_from_numpy(FLAT)
    with torch.no_grad():
        dense = block_covariance(
            params, joint_distance_blocks([torch.as_tensor(c) for c in coords], geodesic=False)
        )
    c = torch.as_tensor(np.concatenate(coords))
    procs = torch.as_tensor(np.repeat([0, 1], [30, 37]))
    V = torch.as_tensor(np.random.default_rng(1).normal(size=(67, 3)))
    calls = []
    plain = K.matern_corr_pairs_plain
    monkeypatch.setattr(K, "matern_corr_pairs_plain", lambda *a: calls.append(1) or plain(*a))
    got = _tiled_rows_matvec(params, c, procs, c, procs, V, False, 16)
    np.testing.assert_allclose(got.numpy(), (dense @ V).numpy(), rtol=1e-10, atol=1e-12)
    assert len(calls) == 5


@pytest.mark.parametrize("i", [0, 1])
def test_iterative_matches_dense_joint_and_jax(setup, i):
    """pred and pred_err match the dense JointPredictor and the reference's
    CG predictor to the solver tolerance (rtol 1e-6, atol 1e-8); rhs_batch
    8 over 13 locations leaves a ragged last chunk, and 67 rows in tiles of
    32 a ragged last tile."""
    coords, values, pc = setup
    mod = MultivariateMatern(params=params_from_numpy(FLAT))
    ijp = IterativeJointPredictor(mod, _mf(coords, values), block=32, rhs_batch=8, tol=1e-10,
                                  maxiter=500, device="cpu")
    got = ijp(i, pc)
    want = JointPredictor(mod, _mf(coords, values), device="cpu")(i, pc)
    np.testing.assert_allclose(got.pred, want.pred, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got.pred_err, want.pred_err, rtol=1e-6, atol=1e-8)
    iters = [k for k, _ in ijp.last_diagnostics]
    assert len(iters) == 3 and 0 < max(iters) < 500  # converged by tolerance
    jout = JIterative(JMod(params=JParams.from_flat(jnp.asarray(FLAT))),
                      _mf(coords, values, JField, JMultiField), block=32, rhs_batch=8,
                      tol=1e-10, maxiter=500)(i, pc, postprocess=False)
    np.testing.assert_allclose(got.pred, jout["pred"].values, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got.pred_err, jout["pred_err"].values, rtol=1e-6, atol=1e-8)


def test_compute_err_false_skips_variance(setup):
    coords, values, pc = setup
    mod = MultivariateMatern(params=params_from_numpy(FLAT))
    got = IterativeJointPredictor(mod, _mf(coords, values), block=32, rhs_batch=8, tol=1e-10,
                                  device="cpu")(0, pc, compute_err=False)
    want = JointPredictor(mod, _mf(coords, values), device="cpu")(0, pc)
    np.testing.assert_allclose(got.pred, want.pred, rtol=1e-6, atol=1e-8)
    assert np.isnan(got.pred_err).all()


def test_non_convergence_warns_and_options_raise(setup):
    coords, values, pc = setup
    mod = MultivariateMatern(params=params_from_numpy(FLAT))
    ijp = IterativeJointPredictor(mod, _mf(coords, values), block=64, rhs_batch=32, tol=1e-12,
                                  maxiter=2, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = ijp(0, pc[:5])
    assert any("did not converge" in str(w.message) for w in caught)
    assert np.isfinite(out.pred).all() and [k for k, _ in ijp.last_diagnostics] == [2, 2]
    with pytest.raises(NotImplementedError):
        ijp(0, pc, postprocess=True)
    with pytest.raises(NotImplementedError):
        IterativeJointPredictor(mod, _mf(coords, values), mesh=object(), device="cpu")
