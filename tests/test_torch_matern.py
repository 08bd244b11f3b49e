"""Port Matern model and the Matern kernel's plain version against the JAX
package (its jnp path and its Pallas kernel in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cokriging_tpu.cov.matern as JM
from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.estimate.nll import joint_distance_blocks
from cokriging_tpu.kernels import pallas_ops as P
from cokriging_tpu_torch.cov import matern as TM
from cokriging_tpu_torch.kernels import cuda_ops as K
from cokriging_tpu_torch.kernels.distance import euclidean_matrix
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

FLAT = np.array([1.2, 0.8, 1.5, 1.1, 2.0, 0.3, 0.25, 0.35, 0.04, 0.02, -0.5])


def test_elementwise_model_matches_jax():
    rng = np.random.default_rng(0)
    h = np.abs(rng.normal(size=(7, 30))) * 0.6
    h[0, :3] = 0.0
    tp = params_from_numpy(FLAT)
    ht = torch.as_tensor(h)
    for jf, tf, args in (
        (JM.covariance, TM.covariance, (0,)), (JM.covariance, TM.covariance, (1,)),
        (JM.cross_covariance, TM.cross_covariance, (0, 1)),
        (JM.semivariance, TM.semivariance, (1,)),
        (JM.cross_semivariance, TM.cross_semivariance, (0, 1)),
        (JM.correlation, TM.correlation, (0, 1)),
    ):
        # jitted: op by op the six references took ~11 s of the CPU run
        ref = np.asarray(jax.jit(lambda f, hh: jf(JParams.from_flat(f), *args, hh))(
            jnp.asarray(FLAT), jnp.asarray(h)))
        np.testing.assert_allclose(tf(tp, *args, ht).numpy(), ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("symmetric", [False, True])
def test_matern_plain_block_matches_pallas_kernel(rng, monkeypatch, symmetric):
    """The kernel's plain version against ``matern_correlation_pallas`` in
    interpret mode, small tiles, f32 (test_pallas_kernel.py's bar)."""
    monkeypatch.setattr(P, "MM", 8)
    monkeypatch.setattr(P, "MN", 128)
    pts = rng.uniform(0, 2000, size=(40, 2))
    h = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    if not symmetric:
        h = h[:13, :37]
    for nu, ls in [(1.5, 500.0), (0.7, 200.0), (3.2, 800.0)]:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(
                P.matern_correlation_pallas(nu, ls, jnp.asarray(h), symmetric=symmetric)
            )
        got = K.matern_correlation_block(nu, ls, torch.as_tensor(h), symmetric=symmetric)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)


def test_block_covariance_matches_jax():
    rng = np.random.default_rng(1)
    coords = [rng.uniform(0, 1, size=(30, 2)), rng.uniform(0, 1, size=(25, 2))]
    jd = joint_distance_blocks([jnp.asarray(c) for c in coords], geodesic=False)
    # jitted: op by op it took ~18 s of the CPU run
    ref = np.asarray(jax.jit(lambda f, d: JM.block_covariance(JParams.from_flat(f), d))(
        jnp.asarray(FLAT), jd))
    tc = [torch.as_tensor(c) for c in coords]
    td = [[euclidean_matrix(tc[i], tc[j]) if i <= j else None for j in range(2)]
          for i in range(2)]
    before = K.launch_counts()
    got = TM.block_covariance(params_from_numpy(FLAT), td).numpy()
    assert K.launch_counts() == before  # the CPU runs the plain version
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(got, got.T)


def test_multivariate_matern_surface():
    mod = TM.MultivariateMatern(params=params_from_numpy(FLAT))
    np.testing.assert_array_equal(mod.get_values(), FLAT)
    mod.set_values(FLAT * 1.1)
    np.testing.assert_allclose(mod.get_values(), FLAT * 1.1)
    with pytest.raises(ValueError):
        TM.MultivariateMatern(n_procs=3, params=params_from_numpy(FLAT))
