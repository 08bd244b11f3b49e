"""Port K_nu against the JAX package and scipy, values and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

from cokriging_tpu.kernels.bessel import kv as jkv
from cokriging_tpu_torch.kernels.bessel import kv

torch.set_num_threads(1)


# the JAX references jitted (op by op each took ~5-12 s of the CPU run),
# each compiled once for every case of its shapes
_jax_grads = jax.jit(jax.grad(lambda a, b: jnp.sum(jkv(a, b)), argnums=(0, 1)))
_jax_order_grad = jax.jit(jax.grad(lambda a, b: jnp.sum(jkv(a, b))))
_jax_lane_order_grads = jax.jit(jax.vmap(jax.grad(jkv), in_axes=(None, 0)))


def _grid(seed=0, n=400):
    rng = np.random.default_rng(seed)
    nu = rng.uniform(0.2, 3.5, n)
    x = np.exp(rng.uniform(np.log(0.01), np.log(30.0), n))
    nu[:6] = [0.5, 1.5, 2.5, 1.0, 2.0, 3.0]  # half-integer and integer orders
    x[:6] = [0.3, 1.9, 2.0, 2.1, 7.0, 25.0]
    return nu, x


def test_kv_matches_scipy_and_jax_f64():
    nu, x = _grid()
    got = kv(torch.as_tensor(nu), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, sp.kv(nu, x), rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jkv(jnp.asarray(nu), jnp.asarray(x))), rtol=1e-12)


def test_kv_f32_and_edge_values():
    nu, x = _grid(1)
    got = kv(torch.as_tensor(nu, dtype=torch.float32), torch.as_tensor(x, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), sp.kv(nu, x), rtol=2e-5)
    edge = kv(1.5, torch.tensor([0.0, -1.0, 1.0], dtype=torch.float64)).numpy()
    assert edge[0] == np.inf and np.isnan(edge[1])
    np.testing.assert_allclose(edge[2], sp.kv(1.5, 1.0), rtol=1e-13)


def test_kv_gradients_match_jax():
    nu, x = _grid(2)
    tn = torch.tensor(nu, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    kv(tn, tx).sum().backward()
    gn, gx = _jax_grads(jnp.asarray(nu), jnp.asarray(x))
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(gn), rtol=1e-8)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-8)


@pytest.mark.parametrize("nu", [0.7, 1.5, 2.3])
def test_kv_scalar_order_gradient_broadcasts(nu):
    """A scalar order against many x (the Matern block case): the order
    gradient is the sum over x, as in JAX."""
    x = np.linspace(0.05, 12.0, 57)
    tn = torch.tensor(nu, dtype=torch.float64, requires_grad=True)
    kv(tn, torch.as_tensor(x)).sum().backward()
    ref = _jax_order_grad(jnp.asarray(nu), jnp.asarray(x))
    np.testing.assert_allclose(tn.grad.item(), float(ref), rtol=1e-8)


def test_order_gradient_beside_half_integers_follows_jax():
    """dK/dnu on the CF2 branch one ulp either side of nu = 1.5: the
    reference truncates the tangent there (a1 = 0.25 - mu^2 is ~1e-16, not
    0, so its freeze fires), and the port follows it; exactly at 1.5 both
    are exact (scipy finite difference)."""
    x = np.array([2.1, 3.0, 8.0])
    ref = {}
    for nu in (np.nextafter(1.5, 0.0), 1.5, np.nextafter(1.5, 2.0)):
        tn = torch.full((3,), nu, dtype=torch.float64, requires_grad=True)
        kv(tn, torch.as_tensor(x)).sum().backward()
        jg = _jax_lane_order_grads(jnp.asarray(nu), jnp.asarray(x))
        np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jg), rtol=1e-12)
        ref[nu] = tn.grad.numpy()
    fd = (sp.kv(1.5 + 1e-6, x) - sp.kv(1.5 - 1e-6, x)) / 2e-6
    np.testing.assert_allclose(ref[1.5], fd, rtol=1e-7)
    below, above = ref[np.nextafter(1.5, 0.0)], ref[np.nextafter(1.5, 2.0)]
    assert np.all(np.abs(below / fd - 1) > 1e-3) and np.all(np.abs(above / fd - 1) > 1e-3)
