"""The port's spectral densities and validity projection against the JAX
package's ``cov/spectral.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import spectral as JS
from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu_torch.cov import spectral as TS
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

# (nu1, l1, nu2, l2, nu12, l12): above the smoothness floor, below it, on it
# (a parsimonious nu12, whose tail test must not read rounding as below)
CASES = [
    (1.5, 300.0, 0.8, 500.0, 1.2, 400.0),
    (0.5, 200.0, 2.5, 900.0, 1.5, 450.0),
    (1.5, 300.0, 0.8, 500.0, 1.0, 400.0),
    (1.1, 300.0, 1.7, 500.0, 1.4, 100.0),
]
# a fit whose cross structure is only valid with |rho| near 0
FLAT = np.array([1.1, 0.9, 1.5, 1.2, 0.7, 300.0, 150.0, 500.0, 0.04, 0.06, -0.95])


def test_spectral_densities_and_scale_conversions_match_jax():
    w = np.concatenate([[0.0], np.logspace(-5, -1, 9)])
    for d in (1, 2):
        np.testing.assert_allclose(
            TS.matern_spectral_density(w, 1.3, 420.0, 1.7, d=d).numpy(),
            np.asarray(JS.matern_spectral_density(w, 1.3, 420.0, 1.7, d=d)), rtol=1e-12)
    np.testing.assert_allclose(TS.matern_spectral_density_1d(w, 0.7, 90.0).numpy(),
                               np.asarray(JS.matern_spectral_density_1d(w, 0.7, 90.0)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(TS.classic_to_rw_len_scale(100.0, 1.5)),
                               float(JS.classic_to_rw_len_scale(100.0, 1.5)), rtol=1e-15)
    np.testing.assert_allclose(float(TS.rw_to_classic_len_scale(100.0, 1.5)),
                               float(JS.rw_to_classic_len_scale(100.0, 1.5)), rtol=1e-15)


@pytest.mark.parametrize("case", CASES)
def test_rho_max_matches_jax(case):
    want = float(JS.rho_max(*case))
    got = TS.rho_max(*case)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-12, atol=0)
    # float32 inputs: computed in float64, the floor test keyed off float32
    c32 = tuple(torch.tensor(v, dtype=torch.float32) for v in case)
    j32 = tuple(jnp.asarray(v, jnp.float32) for v in case)
    np.testing.assert_allclose(float(TS.rho_max(*c32)), float(JS.rho_max(*j32)), rtol=1e-12)


@pytest.mark.parametrize("kw", [{}, {"parsimony": True}, {"lift_nu": False}, {"margin": 0.9}])
def test_project_to_valid_matches_jax(kw):
    got = TS.project_to_valid(params_from_numpy(FLAT), **kw)
    want = JS.project_to_valid(JParams.from_flat(jnp.asarray(FLAT)), **kw)
    np.testing.assert_allclose(got.to_flat().numpy(), np.asarray(want.to_flat()),
                               rtol=1e-12, atol=1e-15)
    for i, j in ((0, 1),):
        np.testing.assert_allclose(float(TS.params_rho_max(got, i, j)),
                                   float(JS.params_rho_max(want, i, j)), rtol=1e-12)
    assert abs(float(got.rho[0, 1])) <= float(TS.params_rho_max(got, 0, 1))


def test_project_to_valid_float32_parsimonious_keeps_rho():
    """A float32 fit snapped to the parsimonious cross structure keeps its
    dtype and a nonzero rho (the float32 midpoint nu12 is on the floor, not
    below it), as in the reference."""
    f32 = FLAT.astype(np.float32)
    got = TS.project_to_valid(params_from_numpy(f32), parsimony=True)
    want = JS.project_to_valid(JParams.from_flat(jnp.asarray(f32)), parsimony=True)
    assert got.rho.dtype == torch.float32
    np.testing.assert_allclose(got.to_flat().numpy(), np.asarray(want.to_flat()),
                               rtol=1e-12, atol=0)
    assert float(got.rho[0, 1]) < -0.5
