"""Port WLS fitting against the JAX package: cost and gradient, the moment
initializer, the Adam fitter (and its optax equivalence) and scipy."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.estimate import empirical as JE, wls as JW
from cokriging_tpu_torch.estimate import empirical as TE, wls as TW
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def estimates():
    """One empirical variogram set, built by the JAX package, in both
    packages' containers."""
    rng = np.random.default_rng(11)
    cs, vs = [], []
    for k in range(2):
        lat, lon = rng.uniform(24, 50, 300), rng.uniform(-124, -67, 300)
        s = np.sin(np.deg2rad(lat) * 6.0) + 0.5 * np.cos(np.deg2rad(lon) * 4.0)
        cs.append(np.column_stack([lat, lon]))
        vs.append((1 - 1.6 * k) * s + rng.normal(scale=0.4, size=300))
    cfg = JE.VarioConfig(max_dist=3000.0, n_bins=15)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pairs, c, m, n = JE.empirical_variograms_device(cs, vs, cfg)
    jest = JE.EmpiricalVariogram(None, cfg, None, None, pairs, c, m, n)
    test = TE.EmpiricalVariogram(TE.VarioConfig(max_dist=3000.0, n_bins=15), pairs, c, m, n)
    return jest, test


def _x0(jest, nu=(1.3, 1.1, 1.2)):
    # off the half-integer orders: there the reference's CF2 dK/dnu jumps by
    # up to ~2% across the order, so a start at exactly nu = 1.5 would be
    # decided by last-ulp rounding of the box transform in each package
    x = np.asarray(JW.moment_init(jest).to_flat()).copy()
    x[2:5] = nu
    return x


def test_cost_and_gradient_match_jax(estimates):
    jest, test = estimates
    for x in (_x0(jest), np.asarray(JW.moment_init(jest).to_flat())):
        jv, jg = JW._cost_and_grad(
            jnp.asarray(x), jnp.asarray(jest.bin_centers), jnp.asarray(jest.bin_means),
            jnp.asarray(jest.bin_counts, jnp.float64), tuple(jest.pairs), JParams.default().spec,
        )
        xt = torch.tensor(x, requires_grad=True)
        tv = TW.composite_wls_cost(
            xt, torch.as_tensor(test.bin_centers), torch.as_tensor(test.bin_means),
            torch.as_tensor(test.bin_counts).double(), tuple(test.pairs), TW.ParamSpec(),
        )
        (tg,) = torch.autograd.grad(tv, xt)
        np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-10)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)


def test_moment_init_matches_jax(estimates):
    jest, test = estimates
    np.testing.assert_allclose(
        TW.moment_init(test).to_flat().numpy(), np.asarray(JW.moment_init(jest).to_flat()),
        rtol=1e-13,
    )


@pytest.mark.parametrize("method,maxiter", [("adam", 50), ("scipy", 15)])
def test_fit_matches_jax(estimates, method, maxiter):
    jest, test = estimates
    x0 = _x0(jest)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, jres = JW.fit_wls(jest, init=JParams.from_flat(jnp.asarray(x0)), method=method,
                              maxiter=maxiter, theoretical=False)
        tp, tres = TW.fit_wls(test, init=params_from_numpy(x0), method=method,
                              maxiter=maxiter, device="cpu")
    np.testing.assert_allclose(tp.to_flat().numpy(), np.asarray(jp.to_flat()), rtol=1e-6)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=1e-6)
    assert tres.n_iter == jres.n_iter


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_adam_is_optax_step_for_step(dtype):
    """Given the same gradients, the hand-written Adam is bit for bit
    ``optax.adam(optax.cosine_decay_schedule(lr, maxiter))``."""
    target = np.linspace(-2.0, 3.0, 7).astype(dtype)
    scale = (2.0 ** np.arange(-3, 4)).astype(dtype)  # exact gradients in both

    def obj_t(u):
        return 0.5 * torch.sum(torch.as_tensor(scale) * (u - torch.as_tensor(target)) ** 2)

    def obj_j(u):
        return 0.5 * jnp.sum(jnp.asarray(scale) * (u - jnp.asarray(target)) ** 2)

    u0 = np.zeros(7, dtype)
    maxiter = 25
    opt = optax.adam(optax.cosine_decay_schedule(0.3, maxiter))
    u = jnp.asarray(u0)
    state = opt.init(u)
    for _ in range(maxiter):
        g = np.asarray(jax.grad(obj_j)(u))
        ug = torch.tensor(np.asarray(u), requires_grad=True)
        (gt,) = torch.autograd.grad(obj_t(ug), ug)
        np.testing.assert_array_equal(gt.numpy(), g)  # same gradients in
        upd, state = opt.update(jnp.asarray(g), state, u)
        u = optax.apply_updates(u, upd)
    got = TW.adam_cosine(obj_t, torch.as_tensor(u0), maxiter)
    assert got.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(u))
