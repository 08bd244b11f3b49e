"""K_nu's second derivatives in the port (``kernels.bessel.kv`` under a
double backward) against the JAX package's (``jax.hessian`` of its ``kv``,
which differentiates the custom JVP rule ``_kv_jvp`` a second time), in
float64 on the CPU; ``kv_ratio`` and ``kv_exact_grad`` against the JAX ones;
the accurate ``trigamma`` behind the second derivative of lgamma; and the
first-order backward, which reuses the forward's partials, against the
graph-building one.

Inputs are a grid of orders and arguments on both branches (x < 2: the
Temme series; x >= 2: CF2), negative orders (|nu| symmetry) and, as a case
of its own, nu = 1.5 and one ulp either side, where the reference's CF2
tangent is truncated and the port follows it. x = 2 exactly is on the grid:
there the branch clamps (``jnp.minimum`` / ``jnp.maximum`` in the reference,
``torch.minimum`` / ``torch.maximum`` in the port) pass half of x's gradient
each, which halves the pair's share of the x-derivatives of the partials.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special

from cokriging_tpu.kernels import bessel as JB
from cokriging_tpu_torch.kernels import bessel as TB

torch.set_num_threads(1)

NUS = [0.3, 0.45, 0.7, 1.2, 1.37, 2.6, 3.3, -0.8, 0.5, 2.5]
XS = [0.002, 0.05, 0.5, 0.9, 1.9, 1.999, 2.0, 2.1, 3.0, 7.0, 15.0, 25.0]
HALF = [1.5, float(np.nextafter(1.5, 0.0)), float(np.nextafter(1.5, 2.0))]
# relative to each point's largest |second derivative|: the two packages
# take the same derivatives of the same recurrences in another operation
# order (measured <= 1.2e-12 on this grid)
TOL = 1e-10


def _grid(nus, xs):
    n, x = np.meshgrid(np.asarray(nus), np.asarray(xs), indexing="ij")
    return n.ravel(), x.ravel()


def _jax_hessians(n, x):
    def h(a, b):
        return jax.hessian(lambda v: JB.kv(v[0], v[1]))(jnp.stack([a, b]))

    return np.asarray(jax.jit(jax.vmap(h))(jnp.asarray(n), jnp.asarray(x)))


def _torch_hessians(n, x):
    """Per point [[d2K/dnu2, d2K/dnu dx], [d2K/dx dnu, d2K/dx2]] by a double
    backward of the port's kv (every lane depends on its own point only)."""
    nu = torch.tensor(n, requires_grad=True)
    xx = torch.tensor(x, requires_grad=True)
    g_nu, g_x = torch.autograd.grad(TB.kv(nu, xx).sum(), (nu, xx), create_graph=True)
    h_nn, h_nx = torch.autograd.grad(g_nu.sum(), (nu, xx), retain_graph=True)
    h_xn, h_xx = torch.autograd.grad(g_x.sum(), (nu, xx))
    return torch.stack([h_nn, h_nx, h_xn, h_xx], 1).reshape(-1, 2, 2).numpy()


@pytest.fixture(scope="module")
def hessians():
    n, x = _grid(NUS + HALF, XS)
    return n, x, _torch_hessians(n, x), _jax_hessians(n, x)


def _rel(a, b):
    return np.abs(a - b).max(axis=(1, 2)) / np.abs(b).max(axis=(1, 2))


def test_second_derivatives_match_jax_off_half_integers(hessians):
    n, x, h_t, h_j = hessians
    off = ~np.isin(n, HALF)
    assert np.isfinite(h_t[off]).all()
    rel = _rel(h_t[off], h_j[off])
    assert rel.max() <= TOL, (n[off][rel.argmax()], x[off][rel.argmax()], rel.max())


def test_second_derivatives_follow_jax_beside_half_integers(hessians):
    """At nu = 1.5 -+ one ulp the CF2 tangent is truncated after one step
    in the reference; the port's second derivatives follow it there, and
    its mixed partials keep the reference's asymmetry (d/dx dK/dnu from the
    truncated tangent, d/dnu dK/dx from the triple)."""
    n, x, h_t, h_j = hessians
    near = np.isin(n, HALF)
    assert _rel(h_t[near], h_j[near]).max() <= TOL
    cf2 = near & (x > 2.0) & (n != 1.5)
    assert np.abs(h_j[cf2, 0, 1] - h_j[cf2, 1, 0]).max() > 1e-4  # the shared quirk


def test_first_order_backward_equals_the_graph_building_one():
    """The first-order backward returns the forward's saved partials; the
    backward under ``create_graph`` rebuilds them from the graph of the
    same pass: the same values to round-off."""
    n, x = _grid(NUS, XS)
    nu = torch.tensor(n, requires_grad=True)
    xx = torch.tensor(x, requires_grad=True)
    fast = torch.autograd.grad(TB.kv(nu, xx).sum(), (nu, xx))
    graph = torch.autograd.grad(TB.kv(nu, xx).sum(), (nu, xx), create_graph=True)
    for a, b in zip(fast, graph):
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(), rtol=1e-13, atol=0)


def _clamped_pair(mu, x):
    """The pair with clamps that pass x's whole gradient at x == 2
    (``torch.clamp_max`` / ``torch.clamp_min``), as the port had them
    before its clamps split the tie."""
    ks_mu, ks_mu1 = TB._temme_series(mu, torch.clamp_max(x, 2.0))
    kc_mu, kc_mu1 = TB._steed_cf2(mu, torch.clamp_min(x, 2.0))
    use_series = x < 2.0
    return torch.where(use_series, ks_mu, kc_mu), torch.where(use_series, ks_mu1, kc_mu1)


def test_first_order_backward_is_bit_equal_with_either_clamp(monkeypatch):
    """kv's value and first-order backward (dK/dx from the recurrence,
    dK/dnu the mu-tangent) never go through the clamps' x-gradient, so they
    are bit for bit the same with clamps that split the tie at x = 2 and
    with clamps that do not, on the whole grid (x = 2 and the half-integer
    orders included)."""
    n, x = _grid(NUS + HALF, XS)

    def value_and_grads():
        nu = torch.tensor(n, requires_grad=True)
        xx = torch.tensor(x, requires_grad=True)
        k = TB.kv(nu, xx)
        return (k.detach(), *torch.autograd.grad(k.sum(), (nu, xx)))

    split = value_and_grads()
    monkeypatch.setattr(TB, "_kv_pair", _clamped_pair)
    whole = value_and_grads()
    for a, b in zip(split, whole):
        assert torch.equal(a, b)


def test_kv_ratio_and_exact_grad_match_jax():
    """Values and first derivatives, float64, relative 1e-12 (the exact
    gradient differentiates the recurrences in both packages); domain x > 0."""
    n, x = _grid([0.3, 0.7, 1.2, 1.37, 2.6, 3.3], [0.05, 0.5, 1.9, 2.1, 7.0, 15.0])
    np.testing.assert_allclose(TB.kv_ratio(torch.tensor(n), torch.tensor(x)).numpy(),
                               np.asarray(jax.jit(JB.kv_ratio)(jnp.asarray(n), jnp.asarray(x))),
                               rtol=1e-12)
    nu = torch.tensor(n, requires_grad=True)
    xx = torch.tensor(x, requires_grad=True)
    k = TB.kv_exact_grad(nu, xx)
    g = torch.autograd.grad(k.sum(), (nu, xx))
    # the JAX values and gradients from one op-by-op pass (its recurrence
    # bounds are concrete only outside jit)
    jk, pull = jax.vjp(JB.kv_exact_grad, jnp.asarray(n), jnp.asarray(x))
    jg = pull(jnp.ones_like(jk))
    np.testing.assert_allclose(k.detach().numpy(), np.asarray(jk), rtol=1e-12)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11)
    np.testing.assert_allclose(k.detach().numpy(), special.kv(n, x), rtol=1e-12)


def test_trigamma_to_round_off():
    """``torch.polygamma(1, .)`` is ~5e-10 off in float64; the port's
    ``trigamma`` (the derivative of its lgamma's digamma) is within 4 ulp of
    scipy's, over the orders a fit takes and the gamma constants' 1 -+ mu."""
    x = np.concatenate([np.linspace(0.2, 3.5, 67), np.linspace(0.5, 1.5, 41), [9.999, 10.0, 30.5]])
    got = TB.trigamma(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, special.polygamma(1, x), rtol=1e-15 * 4)
    nu = torch.tensor(x, requires_grad=True)
    (d,) = torch.autograd.grad(TB.lgamma(nu).sum(), nu, create_graph=True)
    (d2,) = torch.autograd.grad(d.sum(), nu)
    # torch's own digamma: absolute round-off near its zero at x ~ 1.4616
    np.testing.assert_allclose(d.detach().numpy(), special.digamma(x), rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(d2.numpy(), special.polygamma(1, x), rtol=1e-15 * 4)
