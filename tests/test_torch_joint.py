"""The port's exact joint predictor against the JAX package: prediction and
LOOCV cores (geodesic and Euclidean), single-point withholding, and the
float32 path with refinement."""

import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.predict import joint as JJ
from cokriging_tpu_torch.cov.matern import MultivariateMatern
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.predict import joint as TJ
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

# a valid bivariate model: common nu and length scale (geodesic in km,
# Euclidean on the unit square), nuggets, moderate cross-correlation
FLAT = {
    True: np.array([1.1, 0.9, 1.3, 1.3, 1.3, 600.0, 600.0, 600.0, 0.05, 0.04, -0.5]),
    False: np.array([1.1, 0.9, 1.3, 1.3, 1.3, 0.3, 0.3, 0.3, 0.05, 0.04, -0.5]),
}


def _problem(geodesic, seed=9, n=80, n_pred=50):
    rng = np.random.default_rng(seed)
    if geodesic:
        draw = lambda k: np.column_stack([rng.uniform(30, 45, k), rng.uniform(-110, -85, k)])
    else:
        draw = lambda k: rng.uniform(0, 1, (k, 2))
    c1, c2, pc = draw(n), draw(n), draw(n_pred)
    c2[:10] = c1[:10]  # colocated observations
    pc[:3] = c1[20:23]  # predictions at data locations
    return c1, rng.normal(size=n), c2, rng.normal(size=n), pc


def _mf(c1, v1, c2, v2, geodesic, dtype=np.float64):
    fields = [Field.from_arrays(c1.astype(dtype), v1.astype(dtype), "Z0"),
              Field.from_arrays(c2.astype(dtype), v2.astype(dtype), "Z1")]
    for f in fields:
        f.geodesic = geodesic
    return MultiField(fields=fields)


@pytest.mark.parametrize("geodesic", [True, False])
@pytest.mark.parametrize("i", [0, 1])
def test_predict_and_loocv_cores_match_jax(geodesic, i):
    c1, v1, c2, v2, pc = _problem(geodesic)
    jp = JParams.from_flat(jnp.asarray(FLAT[geodesic]))
    jc = (jnp.asarray(c1), jnp.asarray(c2))
    jv = (jnp.asarray(v1), jnp.asarray(v2))
    want_p, want_e = JJ._joint_predict_core(jp, jc, jv, jnp.asarray(pc), i, geodesic, (80, 80))
    want_lp, want_le = JJ._loocv_core(jp, jc, jv, i, geodesic, (80, 80))

    tp = params_from_numpy(FLAT[geodesic])
    tc = (torch.as_tensor(c1), torch.as_tensor(c2))
    tv = (torch.as_tensor(v1), torch.as_tensor(v2))
    got_p, got_e = TJ._joint_predict_core(tp, tc, tv, torch.as_tensor(pc), i, geodesic)
    got_lp, got_le = TJ._loocv_core(tp, tc, tv, i, geodesic)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-8)
    # at the three data locations the variance is 0 up to rounding, and the
    # root magnifies an ulp to 1e-8: hold the variance there
    np.testing.assert_allclose(got_e.numpy()[3:], np.asarray(want_e)[3:], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got_e.numpy() ** 2, np.asarray(want_e) ** 2, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got_le.numpy(), np.asarray(want_le), rtol=0, atol=1e-8)
    assert not bool(JJ._verify_core(jp, jc, jnp.asarray(pc[3:]), i, geodesic))
    assert not TJ._verify_core(tp, tc, torch.as_tensor(pc[3:]), i, geodesic)


def test_predictor_surface_and_withholding():
    """``JointPredictor`` returns the port's prediction container; the
    naive delete-and-refactorize LOOCV (``cv_ix``) equals the precision
    identity; an invalid model warns."""
    c1, v1, c2, v2, pc = _problem(False, n=30, n_pred=12)
    mf = _mf(c1, v1, c2, v2, False)
    jp = TJ.JointPredictor(MultivariateMatern(params=params_from_numpy(FLAT[False])), mf, device="cpu")
    out = jp(0, pc[3:], postprocess=False)
    assert out.pred.shape == out.pred_err.shape == (9,) and not out.geodesic
    assert np.isfinite(out.pred).all() and (out.pred_err >= 0).all()
    assert (out.n_neighbors == 60).all()
    frame_cols = ("x", "y", "pred", "pred_err")
    assert tuple(out.to_dataframe().columns) == frame_cols

    fast = jp.cross_validation(1, postprocess=False, method="fast")
    naive = jp.cross_validation(1, postprocess=False, method="naive")
    np.testing.assert_allclose(naive.pred, fast.pred, rtol=0, atol=1e-8)
    np.testing.assert_allclose(naive.pred_err, fast.pred_err, rtol=0, atol=1e-8)
    np.testing.assert_allclose(fast.coords, c2)

    one = jp(1, c2[4], postprocess=False, cv_ix=4)
    np.testing.assert_allclose(one.pred[0], fast.pred[4], atol=1e-8)

    bad = FLAT[False].copy()
    bad[[8, 9, 10]] = [0.0, 0.0, 1.0]  # rho = 1 on colocated points, no nugget
    jp_bad = TJ.JointPredictor(MultivariateMatern(params=params_from_numpy(bad)), mf, device="cpu")
    with pytest.warns(UserWarning, match="not positive definite"):
        out_bad = jp_bad(0, pc[3:], postprocess=False)
    assert np.isnan(out_bad.pred).all()
    # fields built from arrays carry no trend: the data-scale frame is the
    # standardized one (the JAX package's postprocess_predictions)
    pd.testing.assert_frame_equal(jp(0, pc[3:], postprocess=True), out.to_dataframe())


def test_float32_with_refinement_tracks_float64():
    c1, v1, c2, v2, pc = _problem(True)
    mod = MultivariateMatern(params=params_from_numpy(FLAT[True]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        o64 = TJ.JointPredictor(mod, _mf(c1, v1, c2, v2, True), device="cpu")(
            0, pc[3:], postprocess=False)
        o32 = TJ.JointPredictor(mod, _mf(c1, v1, c2, v2, True, np.float32), device="cpu")(
            0, pc[3:], postprocess=False)
    assert o32.pred.dtype == np.float32
    np.testing.assert_allclose(o32.pred, o64.pred, rtol=0, atol=1e-4)
    np.testing.assert_allclose(o32.pred_err, o64.pred_err, rtol=0, atol=1e-4)


def test_refined_solve_beats_the_plain_float32_solve():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(60, 60))
    a = q @ q.T + 1e-2 * np.eye(60)
    b = rng.normal(size=(60, 7))
    exact = np.linalg.solve(a, b)
    a32, b32 = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    plain = TJ._refined_posdef_solve(a32, b32, refine_iters=0).double().numpy()
    refined = TJ._refined_posdef_solve(a32, b32).double().numpy()
    assert np.abs(refined - exact).max() < 0.1 * np.abs(plain - exact).max()
    assert torch.isnan(TJ._refined_posdef_solve(-a32, b32)).all()


def test_triangular_and_spd_inverses_match_jax():
    from cokriging_tpu.kernels import linalg as JL
    from cokriging_tpu_torch.kernels import linalg as TL

    rng = np.random.default_rng(4)
    q = rng.normal(size=(70, 70))
    chol = np.linalg.cholesky(q @ q.T + 70.0 * np.eye(70))
    dirty = chol + np.triu(rng.normal(size=(70, 70)), 1)  # upper entries are ignored
    got = TL.tri_inv_lower(torch.as_tensor(dirty)).numpy()
    np.testing.assert_allclose(got, np.asarray(JL.tri_inv_lower(jnp.asarray(dirty))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got @ chol, np.eye(70), rtol=0, atol=1e-12)
    inv = TL.spd_inverse_from_chol(torch.as_tensor(chol)).numpy()
    np.testing.assert_allclose(inv, np.asarray(JL.spd_inverse_from_chol(jnp.asarray(chol))), rtol=0, atol=1e-12)
