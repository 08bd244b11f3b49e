"""The gaps closed in the port's ported modules, against the JAX package on
the CPU in float64: ``MaternParams.replace`` / ``to_dataframe``, the Vincenty
distances, ``variogram_value`` and ``MultivariateMatern.variograms`` /
``.fit``, ``joint_covariance_from_coords``, the validity checks of the WLS fit
(``cauchy_schwarz_check``, ``validity_penalty`` weighted into Adam,
``project_validity``), ``FitResult``'s frames, and ``empirical_variograms(mf)``
/ ``empirical_variogram_pair``."""

import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cokriging_tpu.cov import matern as JM
from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.estimate import empirical as JE, wls as JW
from cokriging_tpu.fields.field import Field as JField, MultiField as JMultiField
from cokriging_tpu.kernels import distance as JD
from cokriging_tpu_torch.cov import matern as TM
from cokriging_tpu_torch.estimate import empirical as TE, wls as TW
from cokriging_tpu_torch.fields.field import Field as TField, MultiField as TMultiField
from cokriging_tpu_torch.kernels import distance as TD
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

VALID = np.array([1.0, 1.3, 1.4, 1.2, 1.1, 500.0, 600.0, 700.0, 0.05, 0.08, -0.4])
# cross smoothness far below the marginals' with |rho| near 1: Cauchy-Schwarz
# fails inside the fitting lags
INVALID = np.array([1.0, 1.3, 1.6, 0.4, 1.5, 500.0, 600.0, 700.0, 0.05, 0.08, -0.95])


def _points(rng, n):
    return np.column_stack([rng.uniform(24, 50, n), rng.uniform(-124, -67, n)])


@pytest.fixture(scope="module")
def month():
    """Two processes of 120 geodesic points, anticorrelated smooth signals
    plus noise, as both packages' MultiFields."""
    rng = np.random.default_rng(21)
    cs = [_points(rng, 120), _points(rng, 110)]
    vs = []
    for k, c in enumerate(cs):
        s = np.sin(np.deg2rad(c[:, 0]) * 6.0) + 0.5 * np.cos(np.deg2rad(c[:, 1]) * 4.0)
        vs.append((1 - 1.6 * k) * s + rng.normal(scale=0.4, size=len(c)))
    out = []
    for F, MF in ((TField, TMultiField), (JField, JMultiField)):
        fields = [F.from_arrays(c, v, f"Z{k}") for k, (c, v) in enumerate(zip(cs, vs))]
        for f in fields:
            f.geodesic = True
        out.append(MF(fields=fields, timestamp="2019-02-01", timedeltas=[0, -1]))
    return cs, vs, out[0], out[1]


@pytest.fixture(scope="module")
def estimates(month):
    _, _, tmf, jmf = month
    cfg = dict(max_dist=3000.0, n_bins=12, n_procs=3)  # n_procs is reset from the fields
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        test = TE.empirical_variograms(tmf, TE.VarioConfig(**cfg), device="cpu")
        jest = JE.empirical_variograms(jmf, JE.VarioConfig(**cfg))
    return test, jest


def test_params_replace_and_frame_match_jax():
    t, j = params_from_numpy(VALID), JParams.from_flat(jnp.asarray(VALID))
    pd.testing.assert_frame_equal(t.to_dataframe(), j.to_dataframe())
    t2 = t.replace(nugget=torch.tensor([0.1, 0.2], dtype=torch.float64))
    j2 = j.replace(nugget=jnp.asarray([0.1, 0.2]))
    np.testing.assert_array_equal(t2.to_flat().numpy(), np.asarray(j2.to_flat()))
    assert t.nugget[0] == 0.05  # replace returns a new object


def test_vincenty_matches_jax():
    rng = np.random.default_rng(4)
    a, b = _points(rng, 9), _points(rng, 7)
    b[:2] = a[:2]  # coincident pairs resolve to exactly 0
    want = np.asarray(JD.vincenty_matrix(a, b))
    got = TD.vincenty_matrix(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    assert got[0, 0] == got[1, 1] == 0.0
    np.testing.assert_array_equal(
        TD.distance_matrix(torch.as_tensor(a), torch.as_tensor(b), exact=True).numpy(), got)
    # Denver -> Chicago on the ellipsoid, ~0.2% off the sphere's 1474 km
    d = TD.distance_matrix(torch.tensor([[39.74, -104.99]]), torch.tensor([[41.88, -87.63]]),
                           exact=True)
    assert 1470.0 < float(d) < 1485.0


@pytest.mark.parametrize("covariogram", [False, True])
def test_variogram_value_and_curves_match_jax(covariogram):
    t, j = params_from_numpy(VALID), JParams.from_flat(jnp.asarray(VALID))
    h = np.linspace(0.0, 2500.0, 37)
    for i, k in ((0, 0), (0, 1), (1, 1)):
        got = TM.variogram_value(t, i, k, torch.as_tensor(h), covariogram=covariogram).numpy()
        want = np.asarray(JM.variogram_value(j, i, k, jnp.asarray(h), covariogram=covariogram))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    kind = "covariogram" if covariogram else "semivariogram"
    pd.testing.assert_frame_equal(TM.MultivariateMatern(params=t).variograms(h, kind),
                                  JM.MultivariateMatern(params=j).variograms(h, kind), rtol=1e-12)


def test_joint_covariance_from_coords_matches_jax(month):
    cs = month[0]
    t, j = params_from_numpy(VALID), JParams.from_flat(jnp.asarray(VALID))
    got = TM.joint_covariance_from_coords(t, [torch.as_tensor(c) for c in cs], True).numpy()
    want = np.asarray(JM.joint_covariance_from_coords(j, [jnp.asarray(c) for c in cs], True))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_cauchy_schwarz_and_penalty_match_jax():
    centers = np.linspace(50.0, 2500.0, 12)
    for flat, valid in ((VALID, True), (INVALID, False)):
        t, j = params_from_numpy(flat), JParams.from_flat(jnp.asarray(flat))
        assert TW.cauchy_schwarz_check(t) is JW.cauchy_schwarz_check(j) is valid
        pt = float(TW.validity_penalty(t, torch.as_tensor(centers)))
        pj = float(JW.validity_penalty(j, jnp.asarray(centers)))
        np.testing.assert_allclose(pt, pj, rtol=1e-10, atol=1e-300)
        assert (pt == 0.0) is valid


def test_projection_on_the_box_fails_cauchy_schwarz_in_both_packages():
    """A shared limit of the validity projection: bench.py's synthetic month
    as frames (chip_smoke phase (h)) fits to the box (nu 0.2 / 3.5 / 0.2,
    ls_22 100 km) in both packages, and there the spectral bound of
    ``rho_max`` admits a rho that fails Cauchy-Schwarz (|C_12| 0.054 against
    sqrt(C_11 C_22) 0.031 at 617 km). The port projects to the JAX package's
    parameters (rtol 1e-12) and reaches the same verdict."""
    from cokriging_tpu.cov.spectral import project_to_valid as jproj
    from cokriging_tpu_torch.cov.spectral import project_to_valid as tproj

    x = np.array([0.87551, 0.87046, 0.2, 3.5, 0.2, 425.13, 570.15, 100.0, 0.2, 0.2, -0.5])
    t = tproj(params_from_numpy(x))
    j = jproj(JParams.from_flat(jnp.asarray(x)))
    np.testing.assert_allclose(t.to_flat().numpy(), np.asarray(j.to_flat()), rtol=1e-12)
    assert abs(float(t.rho[0, 1])) < 0.5
    assert TW.cauchy_schwarz_check(t) is JW.cauchy_schwarz_check(j) is False


def test_empirical_variograms_of_a_multifield_match_jax(month, estimates):
    test, jest = estimates
    assert test.config.n_procs == jest.config.n_procs == 2
    assert (test.timestamp, test.timedeltas) == (jest.timestamp, jest.timedeltas)
    assert test.pairs == list(jest.pairs)
    np.testing.assert_array_equal(test.bin_counts, jest.bin_counts)
    pd.testing.assert_frame_equal(test.df, jest.df, rtol=1e-12, check_dtype=False)
    # one variogram alone: the pair form of the reference
    cs, vs = month[0], month[1]
    cfg = dict(max_dist=2000.0, n_bins=9)
    for a, b, marginal in ((0, 0, True), (0, 1, False)):
        got = TE.empirical_variogram_pair(cs[a], vs[a], cs[b], vs[b], TE.VarioConfig(**cfg),
                                          marginal, device="cpu")
        want = JE.empirical_variogram_pair(cs[a], vs[a], cs[b], vs[b], JE.VarioConfig(**cfg),
                                           marginal)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-12)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    with pytest.raises(ValueError, match="No pairs within max_dist"):
        TE.empirical_variogram_pair(cs[0], vs[0], cs[0], vs[0],
                                    TE.VarioConfig(max_dist=1e-3, n_bins=5), True, device="cpu")


def _x0(jest):
    # off the half-integer orders (the reference's CF2 dK/dnu jumps there)
    x = np.asarray(JW.moment_init(jest).to_flat()).copy()
    x[2:5] = (1.3, 1.1, 1.2)
    return x


def test_fit_wls_project_validity_matches_jax(estimates):
    test, jest = estimates
    x0 = _x0(jest)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, jres = JW.fit_wls(jest, init=JParams.from_flat(jnp.asarray(x0)), maxiter=15,
                              project_validity=True)
        tp, tres = TW.fit_wls(test, init=params_from_numpy(x0), maxiter=15,
                              project_validity=True, device="cpu")
    np.testing.assert_allclose(tp.to_flat().numpy(), np.asarray(jp.to_flat()), rtol=1e-6)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=1e-6)
    assert tres.cs_valid and jres.cs_valid
    pd.testing.assert_frame_equal(tres.df_empirical, jres.df_empirical, rtol=1e-12,
                                  check_dtype=False)
    pd.testing.assert_frame_equal(tres.df_theoretical, jres.df_theoretical, rtol=1e-5)
    _, off = TW.fit_wls(test, init=params_from_numpy(x0), maxiter=2, theoretical=False,
                        device="cpu")
    assert off.df_theoretical is None


def test_fit_wls_validity_weight_matches_jax(estimates):
    """Adam with the validity penalty from a start that violates
    Cauchy-Schwarz inside the fitting lags (a cross length scale far above
    the marginals' with |rho| near 1), so the penalty steers the steps."""
    test, jest = estimates
    x0 = _x0(jest)
    x0[6], x0[-1] = 1900.0, -0.95
    start = params_from_numpy(x0)
    assert not TW.cauchy_schwarz_check(start)
    assert float(TW.validity_penalty(start, torch.as_tensor(test.bin_centers))) > 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, jres = JW.fit_wls(jest, init=JParams.from_flat(jnp.asarray(x0)), method="adam",
                              maxiter=25, validity_weight=1.0, theoretical=False)
        tp, tres = TW.fit_wls(test, init=params_from_numpy(x0), method="adam", maxiter=25,
                              validity_weight=1.0, device="cpu")
        free, _ = TW.fit_wls(test, init=params_from_numpy(x0), method="adam", maxiter=25,
                             device="cpu")
    np.testing.assert_allclose(tp.to_flat().numpy(), np.asarray(jp.to_flat()), rtol=1e-6)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=1e-6)
    assert not np.allclose(free.to_flat().numpy(), tp.to_flat().numpy(), rtol=1e-3)


def test_multivariate_matern_fit_is_fit_wls(estimates):
    """``MultivariateMatern.fit`` is ``fit_wls`` from the model's parameters
    (the JAX class's delegation), storing the parameters and the result. Its
    500 L-BFGS-B iterations run into the box bounds on this small month, where
    the two packages' paths part at the 1e-2 level, so the parity with the JAX
    fit is held by the 15-iteration fits above."""
    test, jest = estimates
    x0 = _x0(jest)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm = TM.MultivariateMatern(params=params_from_numpy(x0)).fit(test, device="cpu")
        tp, tres = TW.fit_wls(test, params_from_numpy(x0), device="cpu")
    np.testing.assert_array_equal(tm.get_values(), tp.to_flat().numpy())
    assert tm.fit_result.cost == tres.cost and tm.fit_result.estimate is test
