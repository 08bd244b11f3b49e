"""The port's dense cofield simulator (``sim/cofield.py``) against the JAX
package's, on the CPU in float64: the grid and its distances, the Cholesky
draw given the JAX package's own normals (p = 2 and p = 3, with nuggets),
the semi-colocated sample indices (numpy's generator in both, index for
index), ``sample`` / ``to_fields`` / ``truth_at``, and the non-PD error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams, MultivariateMatern as JMod
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.sim import BivariateRandomField as JField, CartesianGrid as JGrid
from cokriging_tpu_torch.cov.matern import MultivariateMatern
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.sim import BivariateRandomField, CartesianGrid, cofield

torch.set_num_threads(1)

FLAT2 = np.array([1.0, 0.8, 1.5, 1.4, 1.0, 0.15, 0.1, 0.1, 0.05, 0.02, -0.4])
# trivariate: sigma(3), nu(6), len_scale(6), nugget(3), rho 01, 02, 12
FLAT3 = np.array([1.0, 1.0, 1.0] + [1.5] * 6 + [0.2] * 6 + [0.05, 0.05, 0.05] + [-0.6, 0.4, -0.2])
SPEC3 = dict(n_procs=3, len_scale_bounds=(0.02, 2.0), sigma_bounds=(0.2, 3.0))


def _models(flat, spec_kw=None):
    spec_kw = spec_kw or {}
    return (JMod(params=JParams.from_flat(jnp.asarray(flat), spec=JSpec(**spec_kw))),
            MultivariateMatern(params=MaternParams.from_flat(torch.as_tensor(flat),
                                                             spec=ParamSpec(**spec_kw))))


def _jax_field_noise(seed, n):
    return torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float64)))


def _jax_sample_noise(seed, p, size):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(p):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (size,))))
    return np.stack(out)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's draw functions fed the JAX package's own normals, split as
    the JAX simulator splits its keys."""
    monkeypatch.setattr(cofield.MultivariateRandomField, "_field_noise",
                        lambda self: _jax_field_noise(self.seed, self.n_procs * self.grid.count))
    monkeypatch.setattr(cofield.MultivariateRandomField, "_sample_noise",
                        lambda self, seed, size: _jax_sample_noise(seed, self.n_procs, size))


def test_grid_coords_and_distances_match_jax():
    jg, tg = JGrid(xcount=12, ycount=9), CartesianGrid(xcount=12, ycount=9, device="cpu")
    assert list(tg.coords.columns) == ["x", "y"] and tg.count == jg.count == 108
    np.testing.assert_array_equal(tg.coords.values, jg.coords.values)
    # expand-grid order: x outer, y inner
    np.testing.assert_array_equal(tg.coords["y"].values[:9], np.linspace(0, 1, 9))
    assert tg._dist is None  # made on first use
    np.testing.assert_allclose(tg.dist.numpy(), np.asarray(jg.dist), rtol=1e-14, atol=1e-15)
    assert tg.dist.dtype == torch.float64


@pytest.mark.parametrize("flat,spec_kw", [(FLAT2, None), (FLAT3, SPEC3)], ids=["p2", "p3"])
def test_dense_field_given_jax_normals_matches_jax(jax_draws, flat, spec_kw):
    """The Cholesky factor is unique, so the fields agree draw for draw."""
    jm, tm = _models(flat, spec_kw)
    jr = JField(jm, JGrid(xcount=12, ycount=9), seed=3)
    tr = BivariateRandomField(tm, CartesianGrid(xcount=12, ycount=9, device="cpu"), seed=3,
                              device="cpu")
    assert tr.n_procs == len(tr.fields) == tm.n_procs
    np.testing.assert_allclose(tr.cmat.numpy(), np.asarray(jr.cmat), rtol=0, atol=1e-13)
    np.testing.assert_allclose(tr.chol_lower.numpy(), np.asarray(jr.chol_lower), rtol=0,
                               atol=1e-12)
    for ft, fj in zip(tr.fields, jr.fields):
        assert list(ft.columns) == list(fj.columns) == ["x", "y", "value"]
        np.testing.assert_array_equal(ft[["x", "y"]].values, fj[["x", "y"]].values)
        np.testing.assert_allclose(ft["value"].values, fj["value"].values, rtol=1e-10,
                                   atol=1e-12)


def test_sample_to_fields_and_truth_match_jax(jax_draws):
    jm, tm = _models(FLAT2)
    jr = JField(jm, JGrid(xcount=12, ycount=9), seed=3)
    tr = BivariateRandomField(tm, CartesianGrid(xcount=12, ycount=9, device="cpu"), seed=3,
                              device="cpu")
    # the sample locations: numpy's generator in both packages, exactly
    for size, seed in ((20, 5), (31, 8)):
        for a, b in zip(tr._split_samp_coords(size, seed), jr._split_samp_coords(size, seed)):
            np.testing.assert_array_equal(a, b)
    ts = tr.sample(size=30, epsilon=[0.1, 0.3], seed=7)
    js = jr.sample(size=30, epsilon=[0.1, 0.3], seed=7)
    for k, (a, b) in enumerate(zip(ts, js)):
        assert list(a.columns) == list(b.columns) == ["x", "y", f"Z{k}"]
        np.testing.assert_array_equal(a[["x", "y"]].values, b[["x", "y"]].values)
        np.testing.assert_allclose(a[f"Z{k}"].values, b[f"Z{k}"].values, rtol=1e-10,
                                   atol=1e-12)
    # half the locations shared, half disjoint
    shared = {tuple(r) for r in ts[0][["x", "y"]].values} & {tuple(r) for r in
                                                            ts[1][["x", "y"]].values}
    assert len(shared) == 15
    # frac and a scalar epsilon
    np.testing.assert_allclose(tr.sample(frac=0.2, seed=4)[1].values,
                               jr.sample(frac=0.2, seed=4)[1].values, rtol=1e-10, atol=1e-12)
    mf = tr.to_fields(ts)
    assert mf.n_procs == 2 and not mf.geodesic
    np.testing.assert_array_equal(mf.fields[1].coords.numpy(), ts[1][["x", "y"]].values)
    np.testing.assert_array_equal(mf.fields[1].values_main.numpy(), ts[1]["Z1"].values)
    assert [f.name for f in tr.to_fields(ts, i=1).fields] == ["Z1"]
    pts = ts[0][["x", "y"]].values
    np.testing.assert_allclose(tr.truth_at(0, pts), jr.truth_at(0, pts), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ts[0]["Z0"].values - tr.truth_at(0, pts),
                               0.1 * _jax_sample_noise(8, 2, 30)[0], rtol=1e-9, atol=1e-12)
    with pytest.raises(AssertionError):
        tr.sample(size=80)


def test_port_draws_are_seeded_and_standard():
    """Without the JAX normals the port draws from its own seeded generator:
    the same seed the same field, another seed another."""
    _, tm = _models(FLAT2)
    grid = CartesianGrid(xcount=6, ycount=5, device="cpu")
    a = BivariateRandomField(tm, grid, seed=1, device="cpu")
    b = BivariateRandomField(tm, grid, seed=1, device="cpu")
    c = BivariateRandomField(tm, grid, seed=2, device="cpu")
    assert np.array_equal(a.fields[0]["value"], b.fields[0]["value"])
    assert not np.array_equal(a.fields[0]["value"], c.fields[0]["value"])
    z = cofield._standard_normal(0, (20000,), "cpu")
    assert z.dtype == torch.float64 and abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1) < 0.03


def test_non_pd_model_raises_in_both_packages():
    # |rho| = 1 with unequal marginal smoothness and no nugget: the joint
    # covariance is not positive definite
    flat = np.array([1.0, 1.0, 2.5, 0.3, 2.5, 0.2, 0.6, 0.2, 0.0, 0.0, 1.0])
    jm, tm = _models(flat)
    with pytest.raises(np.linalg.LinAlgError):
        JField(jm, JGrid(xcount=10, ycount=10), seed=0)
    with pytest.raises(np.linalg.LinAlgError):
        BivariateRandomField(tm, CartesianGrid(xcount=10, ycount=10, device="cpu"), seed=0,
                             device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _models(FLAT2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BivariateRandomField(tm, CartesianGrid(xcount=4, ycount=4, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CartesianGrid(xcount=4, ycount=4).dist
