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
from cokriging_tpu.predict import iterative as JI
from cokriging_tpu_torch.cov.matern import MultivariateMatern, block_covariance, pair_table
from cokriging_tpu_torch.estimate.nll import joint_distance_blocks
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.kernels import cuda_ops as K
from cokriging_tpu_torch.predict import iterative as TI
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


def test_cg_residual_trajectory_follows_jax(setup, monkeypatch):
    """The mean solve's relative residual, iteration by iteration (40 of
    them, tol 0), of the port's ``_pcg`` and of the JAX package's CG
    (``_pcg_init_core``, then ``_pcg_segment_core`` one iteration at a time,
    as ``_pcg_host`` drives it) on one float64 system. The two agree to
    rtol 1e-6 for the first 15 iterations; then round-off parts them, and
    the residual of both rises at some iterations (CG's residual is not
    monotone; its error's C-norm is) while both fall by four orders of
    magnitude overall. So a residual that grows between two iterations is
    the conditioning and round-off both packages share, not a fault of the
    port. The port's per-iteration residuals come from ``_pcg`` at maxiter
    1 .. 40 (CG from one start is deterministic), its matvecs memoized."""
    coords, values, _ = setup
    c = np.concatenate(coords)
    procs = np.repeat([0, 1], [30, 37])
    z = np.concatenate(values)
    block, iters = 32, 40
    pad = (-len(c)) % block
    mask = np.r_[np.ones(len(c)), np.zeros(pad)]
    jargs = (JParams.from_flat(jnp.asarray(FLAT)), jnp.asarray(np.r_[c, np.repeat(c[-1:], pad, 0)]),
             jnp.asarray(np.r_[procs, np.repeat(procs[-1:], pad)], dtype=jnp.int32),
             jnp.asarray(mask))
    statics = dict(geodesic=False, block=block, mesh=None)
    state, diag, bnorm = JI._pcg_init_core(*jargs, jnp.asarray(np.r_[z, np.zeros(pad)])[:, None],
                                           **statics)
    jax_rel = []
    for _ in range(iters):
        state, _, rel = JI._pcg_segment_core(*jargs, diag, bnorm, state, 0.0, seg=1, **statics)
        jax_rel.append(float(rel))

    seen = {}
    matvec = TI._tiled_rows_matvec

    def memo(*args):
        key = args[5].numpy().tobytes()
        if key not in seen:
            seen[key] = matvec(*args)
        return seen[key].clone()

    monkeypatch.setattr(TI, "_tiled_rows_matvec", memo)
    params = params_from_numpy(FLAT)
    ct, pt, zt = torch.as_tensor(c), torch.as_tensor(procs), torch.as_tensor(z)[:, None]
    table = pair_table(params, ct.device, ct.dtype)
    port_rel = []
    with torch.no_grad():
        for k in range(1, iters + 1):
            _, done, rel = TI._pcg(params, ct, pt, zt, 0.0, k, False, block, table)
            assert done == k
            port_rel.append(rel)
    assert len(seen) == iters
    jax_rel, port_rel = np.array(jax_rel), np.array(port_rel)
    np.testing.assert_allclose(port_rel[:15], jax_rel[:15], rtol=1e-6)
    for rel in (jax_rel, port_rel):
        assert (np.diff(rel[15:]) > 0).any()  # rises at some iterations
        assert rel[-5:].min() <= 1e-4 * rel[0]
