"""The port's circulant-embedding simulator (``sim/spectral.py``) and the
spectral round trip (``cov/spectral.py``) against the JAX package, on the
CPU in float64: the spectrum, its PSD verdict and the square root B, the
draws given the JAX package's own complex normals, the embedded covariance
against the dense blocks, the ensemble covariance, ``bessel_j0`` and
``spectral_correlation_roundtrip``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from cokriging_tpu.cov import MaternParams as JParams, MultivariateMatern as JMod
from cokriging_tpu.cov import spectral as JS
from cokriging_tpu.sim import CartesianGrid as JGrid, SpectralRandomField as JField
from cokriging_tpu_torch.cov import spectral as TS
from cokriging_tpu_torch.cov.matern import MultivariateMatern, block_covariance
from cokriging_tpu_torch.kernels.distance import euclidean_matrix
from cokriging_tpu_torch.sim import CartesianGrid, SpectralRandomField, spectral
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

# Gneiting-valid with margin (tests/test_spectral_sim.py's model)
FLAT = np.array([1.0, 0.8, 1.5, 1.4, 1.0, 0.15, 0.1, 0.1, 0.05, 0.02, -0.4])


def _jax_eps(seed, n_draw, mx, my, p):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    shape = (n_draw, mx, my, p)
    return torch.complex(torch.tensor(np.asarray(jax.random.normal(k1, shape, jnp.float64))),
                         torch.tensor(np.asarray(jax.random.normal(k2, shape, jnp.float64))))


@pytest.fixture(scope="module")
def fields():
    jm = JMod(params=JParams.from_flat(jnp.asarray(FLAT)))
    tm = MultivariateMatern(params=params_from_numpy(FLAT))
    jf = JField(jm, JGrid(xcount=12, ycount=9), seed=3)
    mp = pytest.MonkeyPatch()
    mp.setattr(spectral.SpectralRandomField, "_eps",
               lambda self, seed, n: _jax_eps(seed, n, self._mx, self._my, self.n_procs))
    tf = SpectralRandomField(tm, CartesianGrid(xcount=12, ycount=9, device="cpu"), seed=3,
                             device="cpu")
    mp.undo()
    return jf, tf, tm


def test_spectrum_verdict_and_root_match_jax(fields):
    jf, tf, _ = fields
    assert (tf._mx, tf._my) == (jf._mx, jf._my) == (32, 32)
    spec_t, min_t = tf._build_spectrum(tf._mx, tf._my, 1 / 11, 1 / 8)
    spec_j, min_j = jf._build_spectrum(jf._mx, jf._my, 1 / 11, 1 / 8)
    scale = np.abs(spec_j).max()
    np.testing.assert_allclose(spec_t, spec_j, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(min_t, min_j, rtol=1e-8, atol=1e-15)
    assert tf.min_rel_eig == pytest.approx(jf.min_rel_eig, rel=1e-8, abs=1e-15)
    assert tf.min_rel_eig >= -1e-9
    np.testing.assert_allclose(tf._B.numpy(), np.asarray(jf._B), rtol=0, atol=1e-12)


def test_draws_given_jax_normals_match_jax(fields, monkeypatch):
    """B is the unique PSD root, so the draws agree draw for draw."""
    jf, tf, _ = fields
    for ft, fj in zip(tf.fields, jf.fields):
        np.testing.assert_array_equal(ft[["x", "y"]].values, fj[["x", "y"]].values)
        np.testing.assert_allclose(ft["value"].values, fj["value"].values, rtol=0, atol=1e-10)
    monkeypatch.setattr(spectral.SpectralRandomField, "_eps",
                        lambda self, seed, n: _jax_eps(seed, n, self._mx, self._my, self.n_procs))
    got = tf.sample_ensemble(5, seed=9)
    want = np.asarray(jf.sample_ensemble(5, seed=9))
    assert got.shape == want.shape == (5, 2, 12, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_embedded_covariance_equals_dense_blocks(fields):
    """The torus covariance the sampler realizes, at every grid pair's
    minimal-image lag, is the dense joint covariance the Cholesky simulator
    factorizes, to 1e-10 of the sill."""
    _, tf, tm = fields
    pts = tf.grid.coords[["x", "y"]].values
    d = euclidean_matrix(torch.as_tensor(pts), torch.as_tensor(pts))
    dense = block_covariance(tm.params, [[d, d], [d, d]]).detach().numpy()
    ix = np.rint(pts[:, 0] * 11).astype(int)
    iy = np.rint(pts[:, 1] * 8).astype(int)
    lag_x = (ix[:, None] - ix[None, :]) % tf._mx
    lag_y = (iy[:, None] - iy[None, :]) % tf._my
    n = len(pts)
    for i in range(2):
        for j in range(2):
            got = tf.embedded_covariance(i, j).numpy()[lag_x, lag_y]
            want = dense[i * n:(i + 1) * n, j * n:(j + 1) * n]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * 1.05)


def test_ensemble_covariance_matches_the_model(fields):
    _, tf, tm = fields
    ens = tf.sample_ensemble(4000, seed=1).numpy()  # (4000, 2, 12, 9), own draws
    z = ens.reshape(4000, 2, -1)
    # marginal variances sigma^2 + nugget; colocated cross-covariance rho s1 s2
    np.testing.assert_allclose(z[:, 0].var(axis=0).mean(), 1.05, rtol=0.05)
    np.testing.assert_allclose(z[:, 1].var(axis=0).mean(), 0.8**2 + 0.02, rtol=0.05)
    cross = (z[:, 0] * z[:, 1]).mean(axis=0).mean()
    np.testing.assert_allclose(cross, -0.4 * 1.0 * 0.8, rtol=0.1)


def test_invalid_model_raises_and_default_device_is_the_card(monkeypatch):
    bad = np.array([1.0, 1.0, 2.5, 0.3, 2.5, 0.2, 0.6, 0.2, 0.0, 0.0, 1.0])
    for make in (lambda: JField(JMod(params=JParams.from_flat(jnp.asarray(bad))),
                                JGrid(xcount=8, ycount=8), max_doublings=1),
                 lambda: SpectralRandomField(MultivariateMatern(params=params_from_numpy(bad)),
                                             CartesianGrid(xcount=8, ycount=8, device="cpu"),
                                             max_doublings=1, device="cpu")):
        with pytest.raises(np.linalg.LinAlgError):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpectralRandomField(MultivariateMatern(params=params_from_numpy(FLAT)),
                            CartesianGrid(xcount=4, ycount=4, device="cpu"))


def test_bessel_j0_matches_jax_and_scipy():
    x = np.concatenate([np.linspace(0.0, 30.0, 601), [-3.0, 7.999, 8.0, 8.001, 1e3]])
    got = TS.bessel_j0(x).numpy()
    np.testing.assert_allclose(got, np.asarray(JS.bessel_j0(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(got, scipy.special.j0(x), rtol=0, atol=1e-7)


@pytest.mark.parametrize("d", [1, 2])
def test_spectral_roundtrip_matches_jax_and_the_correlation(d):
    from cokriging_tpu_torch.cov.matern import matern_correlation

    h = np.array([0.0, 0.05, 0.2, 0.5])
    got = TS.spectral_correlation_roundtrip(1.5, 0.3, h, d=d).numpy()
    want = np.asarray(JS.spectral_correlation_roundtrip(1.5, 0.3, jnp.asarray(h), d=d))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got, matern_correlation(1.5, 0.3, torch.as_tensor(h)).numpy(),
                               atol=2e-3)
    with pytest.raises(NotImplementedError):
        TS.spectral_correlation_roundtrip(1.5, 0.3, h, d=3)
