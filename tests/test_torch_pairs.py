"""The port's gathered-pairs Matern correlation (plain versions, the
arithmetic of the CUDA kernels), its autograd Function and the covariances
built on it, against the JAX package's jnp path (what it runs on the CPU),
in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cokriging_tpu.cov.matern as JM
from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu_torch.cov import matern as TM
from cokriging_tpu_torch.kernels import cuda_ops as K
from cokriging_tpu_torch.kernels.distance import euclidean_matrix
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

NU_PAIRS = {
    1: [1.37],
    3: [0.45, 1.5, 2.8],
    6: [0.3, 0.7, 1.5, 2.2, np.nextafter(1.5, 0.0), 3.1],
}
LS_PAIRS = [250.0, 500.0, 900.0, 320.0, 610.0, 1400.0]
FLAT = np.array([1.2, 0.8, 1.5, 1.1, 2.0, 300.0, 250.0, 350.0, 0.04, 0.02, -0.5])


def _f64(v):
    return torch.tensor(v, dtype=torch.float64)


def _entries(seed, shape, n_pairs):
    """Distances with exact zeros spanning x = 2 at every pair, the float
    index plane and a cotangent."""
    rng = np.random.default_rng(seed)
    h = np.abs(rng.normal(size=shape)) * 800.0
    h.reshape(-1)[::97] = 0.0
    idx = rng.integers(0, n_pairs, size=shape).astype(np.float64)
    return h, idx, rng.normal(size=shape)


# the JAX references jitted (op by op each took ~2-8 s per case of the CPU
# run)
_jax_pairs = jax.jit(JM.matern_corr_pairs)


@jax.jit
def _jax_pairs_grad(nu, ls, idx, h, ct):
    """jax.grad of the same loss."""
    return jax.grad(lambda a, b: jnp.sum(ct * JM.matern_corr_pairs(a, b, idx, h)),
                    argnums=(0, 1))(nu, ls)


def _jax_loss_grad(nu, ls, idx, h, ct):
    return _jax_pairs_grad(jnp.asarray(nu), jnp.asarray(ls), jnp.asarray(idx), jnp.asarray(h),
                           jnp.asarray(ct))


@pytest.mark.parametrize("n_pairs,shape", [(1, (3, 11, 11)), (3, (7, 41, 41)), (6, (1800,))])
def test_pairs_forward_matches_jax(n_pairs, shape):
    """Plain version, the public function and the autograd Function on the
    CPU against the reference's jnp path, atol 1e-12; ragged shapes."""
    h, idx, _ = _entries(11, shape, n_pairs)
    nu, ls = NU_PAIRS[n_pairs], LS_PAIRS[:n_pairs]
    want = np.asarray(_jax_pairs(jnp.asarray(nu), jnp.asarray(ls), jnp.asarray(idx),
                                 jnp.asarray(h)))
    args = (_f64(nu), _f64(ls), torch.as_tensor(idx), torch.as_tensor(h))
    for got in (K.matern_corr_pairs_plain(*args), K.matern_corr_pairs(*args),
                TM.matern_corr_pairs(*args), TM._MaternCorrPairs.apply(*args)):
        assert got.shape == shape and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_pair_index_follows_the_reference_select():
    """Values that are not a pair number 1 .. n_pairs-1 select pair 0."""
    idx = np.array([0.0, 1.0, 2.0, 2.5, -1.0, 3.0, 7.0, 1.0000001])
    h = np.full(idx.shape, 400.0)
    nu, ls = [0.7, 1.5, 2.2], [250.0, 500.0, 900.0]
    want = np.asarray(_jax_pairs(jnp.asarray(nu), jnp.asarray(ls), jnp.asarray(idx),
                                 jnp.asarray(h)))
    assert K.pair_index(torch.as_tensor(idx), 3).tolist() == [0, 1, 2, 0, 0, 0, 0, 0]
    got = K.matern_corr_pairs_plain(_f64(nu), _f64(ls), torch.as_tensor(idx),
                                    torch.as_tensor(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("n_pairs", [1, 3, 6])
def test_pairs_grad_matches_jax_grad(n_pairs):
    """Per-pair sums of ct dM/dnu and ct dM/dls against jax.grad of the same
    loss, rtol 1e-10: the exact dK/dnu tangent on both sides (the six-pair
    case holds nu = 1.5 - ulp, where the reference truncates the CF2
    tangent, and nu = 0.3, 0.7 below the first order)."""
    h, idx, ct = _entries(12, (1800,), n_pairs)
    nu, ls = NU_PAIRS[n_pairs], LS_PAIRS[:n_pairs]
    want_nu, want_ls = _jax_loss_grad(nu, ls, idx, h, ct)
    got = K.matern_corr_pairs_grad_plain(_f64(nu), _f64(ls),
                                         torch.as_tensor(idx), torch.as_tensor(h),
                                         torch.as_tensor(ct))
    assert got.shape == (n_pairs, 2) and got.dtype == torch.float64
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want_nu), rtol=1e-10)
    np.testing.assert_allclose(got[:, 1].numpy(), np.asarray(want_ls), rtol=1e-10)
    mag = K.matern_corr_pairs_grad_plain(_f64(nu), _f64(ls),
                                         torch.as_tensor(idx), torch.as_tensor(h),
                                         torch.as_tensor(ct), absolute=True)
    assert bool((mag >= got.abs()).all()) and bool((mag > 0).all())


def test_pairs_function_backward_equals_plain_autograd():
    """The autograd Function on the CPU (plain forward, plain per-pair
    gradient) gives the same parameter gradients as ordinary autograd
    through the public function's CPU path, and h none."""
    h, idx, ct = _entries(13, (9, 23), 3)
    nu, ls = NU_PAIRS[3], LS_PAIRS[:3]
    grads = []
    for fn in (TM._MaternCorrPairs.apply, TM.matern_corr_pairs):
        a = _f64(nu).requires_grad_(True)
        b = _f64(ls).requires_grad_(True)
        out = fn(a, b, torch.as_tensor(idx), torch.as_tensor(h))
        grads.append(torch.autograd.grad((torch.as_tensor(ct) * out).sum(), (a, b)))
    for g_fn, g_ad in zip(*grads):
        np.testing.assert_allclose(g_fn.numpy(), g_ad.numpy(), rtol=1e-12)


def _windows(seed, C=9, w=13):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1500, size=(C, w, 2))
    coords[:, 3] = coords[:, 1]  # colocated slots: exact-zero distances
    procs = rng.integers(0, 2, size=(C, w))
    mvar = rng.uniform(0, 0.05, size=(C, w))
    return coords, procs, mvar


def test_windows_covariance_matches_gathered_and_jax():
    """Lower-triangle windows == per-window gathered covariance + diag(mvar)
    in the port, and both == the reference's, rtol 1e-12; symmetric."""
    coords, procs, mvar = _windows(13)
    d = euclidean_matrix(torch.as_tensor(coords), torch.as_tensor(coords))
    params = params_from_numpy(FLAT)
    got = TM.windows_covariance(params, d, torch.as_tensor(procs), torch.as_tensor(mvar))
    want = np.asarray(jax.jit(lambda f, *a: JM.windows_covariance(JParams.from_flat(f), *a))(
        jnp.asarray(FLAT), jnp.asarray(d.numpy()), jnp.asarray(procs), jnp.asarray(mvar)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    for a in range(coords.shape[0]):
        g = TM.gathered_covariance(params, d[a], torch.as_tensor(procs[a]))
        np.testing.assert_allclose(got[a].numpy(), g.numpy() + np.diag(mvar[a]),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got[a].numpy(), got[a].numpy().T, atol=1e-12)


def test_gathered_covariance_rectangular_matches_jax():
    """Rows and columns of different process sets (the CG row tile and the
    prediction cross-covariance), with exact zeros, against the reference."""
    rng = np.random.default_rng(14)
    ca = rng.uniform(0, 1000, size=(17, 2))
    cb = np.concatenate([ca[:5], rng.uniform(0, 1000, size=(30, 2))])
    pa, pb = rng.integers(0, 2, 17), rng.integers(0, 2, 35)
    d = euclidean_matrix(torch.as_tensor(ca), torch.as_tensor(cb))
    got = TM.gathered_covariance(params_from_numpy(FLAT), d, torch.as_tensor(pa),
                                 torch.as_tensor(pb))
    want = np.asarray(jax.jit(lambda f, *a: JM.gathered_covariance(JParams.from_flat(f), *a))(
        jnp.asarray(FLAT), jnp.asarray(d.numpy()), jnp.asarray(pa), jnp.asarray(pb)))
    assert int((d == 0).sum()) == 5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
