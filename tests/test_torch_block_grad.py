"""The port's Matern block gradient (plain version, the arithmetic of the
CUDA kernel) against the JAX package: jax.grad of the jnp covariance block,
the Pallas kernel in interpret mode, the gamma-constant tangents, and the
block autograd Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cokriging_tpu.cov.matern as JM
from cokriging_tpu.kernels import bessel as JB
from cokriging_tpu.kernels import pallas_ops as P
from cokriging_tpu_torch.cov.matern import _ScaledMaternBlock, block_covariance
from cokriging_tpu_torch.cov.params import MaternParams
from cokriging_tpu_torch.kernels import bessel as TB
from cokriging_tpu_torch.kernels import cuda_ops as K

torch.set_num_threads(1)

SCALE, NUGGET, LS = 1.7, 0.05, 450.0


def _block(seed, n=17, m=140, dtype=np.float64):
    """A ragged distance block with an exact zero, and a cotangent."""
    rng = np.random.default_rng(seed)
    h = (np.abs(rng.normal(size=(n, m))) * 600.0).astype(dtype)
    h[0, 0] = 0.0
    return h, rng.normal(size=(n, m)).astype(dtype)


@jax.jit
def _jax_block_grad(p, h, ct):
    """Reverse mode through the jnp block, jitted once for every case of
    the same shape (op by op it took ~7 s per case of the CPU run)."""
    return jax.grad(lambda q: jnp.sum(ct * JM._scaled_matern_raw(q[0], q[1], q[2], q[3], h)))(p)


def _jax_grad(nu, h, ct, dtype=jnp.float64):
    return np.asarray(_jax_block_grad(jnp.asarray([SCALE, NUGGET, nu, LS], dtype),
                                      jnp.asarray(h), jnp.asarray(ct)))


@pytest.mark.parametrize("nu", [0.3, 1.37, 1.5, 2.6])
def test_plain_block_grad_matches_jax_grad(nu):
    """All four scalar cotangents against reverse mode through the jnp
    block (the reference on the CPU); nu = 0.3 takes the downward step of
    the value triple, nu = 1.5 the half-integer CF2 lanes. rtol 1e-7."""
    h, ct = _block(0)
    got = K.matern_block_grad_plain(SCALE, NUGGET, nu, LS, torch.as_tensor(h), torch.as_tensor(ct))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _jax_grad(nu, h, ct), rtol=1e-7)


@pytest.mark.parametrize("nu", [np.nextafter(1.5, 0.0), np.nextafter(1.5, 2.0)])
def test_plain_block_grad_beside_half_integer_follows_jax(nu):
    """One ulp either side of nu = 1.5 the reference truncates the CF2
    tangent; the block gradient follows it there too."""
    h, ct = _block(1)
    got = K.matern_block_grad_plain(SCALE, NUGGET, nu, LS, torch.as_tensor(h), torch.as_tensor(ct))
    np.testing.assert_allclose(got.numpy(), _jax_grad(nu, h, ct), rtol=1e-7)


def test_plain_block_grad_f32_matches_pallas_interpret(monkeypatch):
    """float32 against ``matern_block_grad_pallas`` in interpret mode with
    shrunken tiles, at the bar the JAX package holds that kernel to against
    its own AD (rtol 2e-2 / atol 1e-4: f32 noise of the nu component)."""
    monkeypatch.setattr(P, "GM", 8)
    monkeypatch.setattr(P, "GN", 128)
    h, ct = _block(2, dtype=np.float32)
    p0 = jnp.asarray([SCALE, NUGGET, 1.37, LS], jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray([float(x) for x in P.matern_block_grad_pallas(
            p0[0], p0[1], p0[2], p0[3], jnp.asarray(h), jnp.asarray(ct))])
    got = K.matern_block_grad_plain(SCALE, NUGGET, 1.37, LS, torch.as_tensor(h), torch.as_tensor(ct))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-4)
    # and the f32 plain version against the f64 one, relative to the sums'
    # own scale (the sums cancel)
    ref = K.matern_block_grad_plain(SCALE, NUGGET, 1.37, LS, torch.as_tensor(h).double(),
                                    torch.as_tensor(ct).double())
    mag = K.matern_block_grad_plain(SCALE, NUGGET, 1.37, LS, torch.as_tensor(h).double(),
                                    torch.as_tensor(ct).double(), absolute=True)
    assert float(((got - ref).abs() / mag).max()) < 1e-5


def test_symmetric_fold_equals_full():
    """Lower triangle with ct + ct^T (diagonal once) == the full block, for
    a symmetric h and an asymmetric cotangent; chunked rows included."""
    rng = np.random.default_rng(3)
    c = rng.uniform(0, 1, size=(41, 2))
    h = torch.as_tensor(np.sqrt(((c[:, None] - c[None]) ** 2).sum(-1)) * 700.0)
    ct = torch.as_tensor(rng.normal(size=h.shape))
    full = K.matern_block_grad_plain(SCALE, NUGGET, 1.37, LS, h, ct)
    sym = K.matern_block_grad_plain(SCALE, NUGGET, 1.37, LS, h, ct, symmetric=True)
    torch.testing.assert_close(sym, full, rtol=1e-10, atol=0.0)
    old = K._PLAIN_GRAD_ELEMS
    try:
        K._PLAIN_GRAD_ELEMS = 5 * 41  # 5-row chunks
        chunked = K.matern_block_grad_plain(SCALE, NUGGET, 1.37, LS, h, ct, symmetric=True)
    finally:
        K._PLAIN_GRAD_ELEMS = old
    torch.testing.assert_close(chunked, full, rtol=1e-10, atol=0.0)
    with pytest.raises(ValueError):
        K.matern_block_grad_plain(SCALE, NUGGET, 1.37, LS, h[:, :20], ct[:, :20], symmetric=True)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_gam12_tangent_matches_jax(dtype, tol):
    mu = np.array([-0.5, -0.3, -1e-4, 0.0, 5e-4, 0.2, 0.37, 0.5], dtype)
    want = JB.gam12_tangent(jnp.asarray(mu))
    got = TB.gam12_tangent(torch.as_tensor(mu))
    for g, w in zip(got, want):
        assert g.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0.0, atol=tol)


def test_host_constants_of_the_kernel():
    """The constants the CUDA wrapper hands its kernel, the head of the dual
    recurrence table (values and d/dmu), against the reference's parameter
    vector (pallas_ops.py:519-525): nu, ls, sqrt(2 nu), mu, nl, gam1, gam2,
    0.5 Gamma(1 + mu), 0.5 Gamma(1 - mu), lgamma, digamma."""
    nu, ls = 2.3, 450.0
    row = K.recurrence_table(torch.tensor([nu], dtype=torch.float64),
                             torch.tensor([ls], dtype=torch.float64), torch.float64,
                             order=1)[0].numpy()
    val, tan = row[0::2], row[1::2]
    nl0 = np.floor(nu + 0.5)
    mu0 = jnp.asarray(nu - nl0)
    g1, g2, igp, igm = (float(v) for v in JB._gam12(mu0))
    d1, d2, dgp, dgm = (float(v) for v in JB.gam12_tangent(mu0))
    want_val = [nu, ls, np.sqrt(2 * nu), float(mu0), nl0, g1, g2, 0.5 / igp, 0.5 / igm,
                float(jax.lax.lgamma(nu)), float(jax.lax.digamma(nu))]
    want_tan = [0.0, 0.0, 0.0, 1.0, 0.0, d1, d2, -0.5 * dgp / igp**2, -0.5 * dgm / igm**2, 0.0, 0.0]
    np.testing.assert_allclose(val[:11], want_val, rtol=1e-12)
    np.testing.assert_allclose(tan[:11], want_tan, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("symmetric", [True, False])
def test_block_function_gradcheck(symmetric):
    rng = np.random.default_rng(4)
    c = torch.as_tensor(rng.uniform(0, 1, size=(6, 2)))
    d = torch.as_tensor(rng.uniform(0, 1, size=(5, 2)))
    h = torch.cdist(c, c if symmetric else d) * 500.0
    if symmetric:
        h = 0.5 * (h + h.T)
        h.fill_diagonal_(0.0)
    args = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for v in (SCALE, NUGGET, 1.37, LS)]
    assert torch.autograd.gradcheck(
        lambda *a: _ScaledMaternBlock.apply(*a, h, symmetric), args,
        eps=1e-6, atol=1e-7, rtol=1e-5,
    )


def test_block_covariance_scalar_cotangent_path_matches_elementwise():
    """``h_grad=False`` (block Function, plain kernels on the CPU) gives the
    value and flat gradient of the elementwise autograd path."""
    rng = np.random.default_rng(5)
    c1 = torch.as_tensor(rng.uniform(0, 1, size=(9, 2)))
    c2 = torch.cat([c1[:3], torch.as_tensor(rng.uniform(0, 1, size=(4, 2)))])
    d = [[torch.cdist(c1, c1) * 500, torch.cdist(c1, c2) * 500], [None, torch.cdist(c2, c2) * 500]]
    for blk in (d[0][0], d[1][1]):
        blk.fill_diagonal_(0.0)
    d[0][1][:3, :3].fill_diagonal_(0.0)
    flat = torch.tensor([1.2, 0.8, 1.5, 1.1, 2.0, 300, 250, 350, 0.04, 0.02, -0.5],
                        dtype=torch.float64, requires_grad=True)
    w = torch.as_tensor(rng.normal(size=(16, 16)))
    outs = []
    for h_grad in (True, False):
        cov = block_covariance(MaternParams.from_flat(flat), d, h_grad=h_grad)
        (g,) = torch.autograd.grad((cov * w).sum(), flat)
        outs.append((cov.detach(), g))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0.0, atol=1e-14)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-9, atol=1e-12)
