"""The port's parametric bootstrap (``estimate/bootstrap.py``) against the
JAX package's, on the CPU in float64: the replicates given the JAX package's
own normals (the Cholesky factor is unique, so draw for draw), the
replicate-batched variograms (counts exactly, means to 1e-10, and against
the per-replicate pass), the refuse-on-drift check, the whole bootstrap fed
the JAX package's replicates, and ``summary()``."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams, MultivariateMatern as JMod
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate import bootstrap as JB
from cokriging_tpu.estimate import VarioConfig as JConfig
from cokriging_tpu.sim import BivariateRandomField as JField, CartesianGrid as JGrid
from cokriging_tpu_torch.cov.matern import MultivariateMatern
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate import bootstrap as TB
from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms_device
from cokriging_tpu_torch.fields.field import Field, MultiField

torch.set_num_threads(1)

TRUTH = np.array([1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.05, 0.05, -0.6])
BOUNDS = dict(sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0), nugget_bounds=(0.0, 0.5))
# a start off the half-integer orders, where the reference's CF2 dK/dnu
# jumps and last-ulp rounding of the box transform decides the fit
INIT = np.array([1.0, 1.0, 1.3, 1.2, 1.1, 0.2, 0.2, 0.2, 0.05, 0.05, -0.5])


@pytest.fixture(scope="module")
def setup():
    """tests/test_bootstrap.py's design: a cofield drawn by the JAX package,
    sampled at 2 x 70 locations without noise, in both packages'
    containers."""
    jmod = JMod(params=JParams.from_flat(jnp.asarray(TRUTH), spec=JSpec(2, **BOUNDS)))
    rf = JField(jmod, JGrid(xcount=17, ycount=17), seed=21)
    samples = rf.sample(size=70, epsilon=[0.0, 0.0], seed=22)
    jmf = rf.to_fields(samples)
    tmf = MultiField(fields=[Field.from_arrays(s[["x", "y"]].values, s[f"Z{k}"].values, f"Z{k}")
                             for k, s in enumerate(samples)])
    tmod = MultivariateMatern(params=MaternParams.from_flat(torch.as_tensor(TRUTH),
                                                            spec=ParamSpec(2, **BOUNDS)))
    return jmod, jmf, tmod, tmf


def _jax_normals(monkeypatch):
    """The port's replicate draws fed the JAX package's normals."""
    def normals(seed, n, n_rep, dtype, device):
        z = jax.random.normal(jax.random.PRNGKey(seed), (n, n_rep), jnp.float64)
        return torch.tensor(np.asarray(z), dtype=dtype, device=device)

    monkeypatch.setattr(TB, "_replicate_noise", normals)


def test_simulate_replicates_given_jax_draws(setup, monkeypatch):
    jmod, jmf, tmod, _ = setup
    _jax_normals(monkeypatch)
    coords = [np.asarray(f.coords) for f in jmf.fields]
    want = JB.simulate_replicates(jmod.params, coords, 8, seed=1, geodesic=False)
    got = TB.simulate_replicates(tmod.params, coords, 8, seed=1, geodesic=False, device="cpu")
    assert [g.shape for g in got] == [w.shape for w in want] == [(8, 70), (8, 70)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10)
    # an invalid generator has no PD covariance in either package
    bad = TRUTH.copy()
    bad[2:5] = [2.5, 0.3, 2.5]
    bad[10], bad[8:10] = 1.0, 0.0
    with pytest.raises(ValueError, match="positive definite"):
        JB.simulate_replicates(JParams.from_flat(jnp.asarray(bad)), coords, 2, geodesic=False)
    with pytest.raises(ValueError, match="positive definite"):
        TB.simulate_replicates(MaternParams.from_flat(torch.as_tensor(bad)), coords, 2,
                               geodesic=False, device="cpu")


def _design(geodesic):
    """Euclidean: the bootstrap's own design; geodesic: 2 x 60 CONUS points
    with every tenth shared."""
    if not geodesic:
        return None
    rng = np.random.default_rng(4)
    c = [np.column_stack([rng.uniform(25, 49, 60), rng.uniform(-120, -70, 60)]) for _ in range(2)]
    c[1][::10] = c[0][::10]
    return c


@pytest.mark.parametrize("geodesic,kind", [(False, "Semivariogram"), (True, "Covariogram")])
def test_batched_variograms_match_jax_and_the_per_replicate_pass(setup, geodesic, kind):
    _, jmf, _, _ = setup
    coords = _design(geodesic) or [np.asarray(f.coords) for f in jmf.fields]
    max_dist = 2000.0 if geodesic else 0.9
    rng = np.random.default_rng(5)
    values = [rng.normal(size=(3, c.shape[0])) for c in coords]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JB.batched_variograms(coords, values, JConfig(max_dist, 10, kind=kind,
                                                             geodesic=geodesic))
        cfg = VarioConfig(max_dist, 10, kind=kind, geodesic=geodesic)
        pairs, centers, means, counts = TB.batched_variograms(coords, values, cfg, device="cpu")
    assert pairs == want[0] == [(0, 0), (0, 1), (1, 1)]
    assert means.shape == (3, 3, 10) and means.dtype == np.float64
    np.testing.assert_allclose(centers, want[1], rtol=1e-12)
    np.testing.assert_array_equal(counts, want[3])
    np.testing.assert_allclose(means, want[2], rtol=1e-10, atol=1e-14, equal_nan=True)
    for b in range(3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            p1, c1, m1, n1 = empirical_variograms_device(coords, [v[b] for v in values], cfg,
                                                         device="cpu")
        assert p1 == pairs
        np.testing.assert_array_equal(c1, centers)
        np.testing.assert_array_equal(n1, counts)
        np.testing.assert_allclose(means[b], m1, rtol=1e-12, atol=1e-15, equal_nan=True)


def test_batched_counts_that_drift_from_the_reference_raise(setup, monkeypatch):
    """A pair moved across a rebuilt edge must stop the bootstrap, as in the
    JAX package, never be re-derived quietly."""
    _, jmf, _, _ = setup
    coords = [np.asarray(f.coords) for f in jmf.fields]
    real = TB.variogram_bin_batch

    def drifted(*args):
        sums, counts = real(*args)
        counts[0, 3] += 1
        return sums, counts

    monkeypatch.setattr(TB, "variogram_bin_batch", drifted)
    values = [np.ones((2, c.shape[0])) for c in coords]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(AssertionError, match="edge reconstruction drifted"):
            TB.batched_variograms(coords, values, VarioConfig(0.9, 10, geodesic=False),
                                  device="cpu")


def test_parametric_bootstrap_fed_jax_replicates_matches_jax(setup, monkeypatch):
    """The same replicates, variograms and refits (40 evaluations per start
    from a shared start off the half-integer orders): each replicate's flat
    vector to 1e-5 and its cost to 1e-6 of the JAX package's. The two
    packages' variogram means differ in the last place, and the refits carry
    that into the results: 3.2e-6 in the flats and 6.6e-8 in the costs for
    two replicates whose nu ends near its upper bound, under 1e-6 and 1e-9
    for the rest."""
    jmod, jmf, tmod, tmf = setup
    _jax_normals(monkeypatch)
    jcfg, tcfg = JConfig(0.9, 10, geodesic=False), VarioConfig(0.9, 10, geodesic=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JB.parametric_bootstrap(jmod, jmf, jcfg, n_rep=8, seed=7, maxiter=40,
                                       init=JParams.from_flat(jnp.asarray(INIT),
                                                              spec=JSpec(2, **BOUNDS)))
        got = TB.parametric_bootstrap(tmod, tmf, tcfg, n_rep=8, seed=7, maxiter=40,
                                      init=MaternParams.from_flat(torch.as_tensor(INIT),
                                                                  spec=ParamSpec(2, **BOUNDS)),
                                      device="cpu")
    assert got.flats.shape == (8, 11) and np.isfinite(got.flats).all()
    np.testing.assert_allclose(got.params.to_flat().numpy(), np.asarray(want.params.to_flat()),
                               rtol=1e-12)
    np.testing.assert_allclose(got.flats, want.flats, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.costs, want.costs, rtol=1e-6)
    lo, hi = ParamSpec(2, **BOUNDS).bounds()
    assert ((got.flats >= lo) & (got.flats <= hi)).all()


def test_per_replicate_starts_are_the_jax_packages(setup, monkeypatch):
    """Without ``init`` each replicate starts from the moment init of its own
    variograms: the starts the JAX package computes, to 1e-12."""
    jmod, jmf, tmod, tmf = setup
    _jax_normals(monkeypatch)
    starts = {}

    def capture(name):
        def fit(x0, *args, **kw):
            starts[name] = np.asarray(x0)
            return np.zeros((x0.shape[0], 11)), np.zeros(x0.shape[0]), np.zeros(x0.shape[0], bool)
        return fit

    monkeypatch.setattr(JB, "fit_wls_batch_arrays", capture("jax"))
    monkeypatch.setattr(TB, "fit_wls_batch_arrays", capture("torch"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JB.parametric_bootstrap(jmod, jmf, JConfig(0.9, 10, geodesic=False), n_rep=5, seed=3)
        TB.parametric_bootstrap(tmod, tmf, VarioConfig(0.9, 10, geodesic=False), n_rep=5,
                                seed=3, device="cpu")
    assert starts["torch"].shape == (5, 11)
    np.testing.assert_allclose(starts["torch"], starts["jax"], rtol=1e-12)


def test_summary_and_mesh(setup):
    jmod, _, tmod, tmf = setup
    flats = np.random.default_rng(2).normal(TRUTH, 0.05, (20, 11))
    costs = np.arange(20.0)
    got = TB.BootstrapResult(tmod.params, flats, costs).summary()
    want = JB.BootstrapResult(jmod.params, flats, costs).summary()
    assert list(got.columns) == list(want.columns) == ["name", "value", "bounds", "std_err",
                                                       "bias", "q025", "q975"]
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12)
    np.testing.assert_allclose(got.attrs["covariance"], want.attrs["covariance"], rtol=1e-12)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        TB.parametric_bootstrap(tmod, tmf, VarioConfig(0.9, 10, geodesic=False), mesh=object(),
                                device="cpu")


def test_default_device_is_the_card(setup, monkeypatch):
    _, _, tmod, tmf = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.parametric_bootstrap(tmod, tmf, VarioConfig(0.9, 10, geodesic=False), n_rep=2)
