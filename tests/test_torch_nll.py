"""The port's exact NLL against the JAX package: value, gradient through
both branches (analytic d(nll)/dC and plain AD through the Cholesky), the
non-PD penalty, and the sigmoid-box value and gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.estimate import nll as JN
from cokriging_tpu_torch.cov.params import MaternParams as TParams
from cokriging_tpu_torch.estimate import nll as TN

torch.set_num_threads(1)

FLAT = np.array([1.1, 0.9, 1.3, 1.45, 1.7, 0.25, 0.22, 0.27, 0.03, 0.02, -0.4])
JSPEC = JParams.default(2).spec
TSPEC = TParams.default(2).spec


@pytest.fixture(scope="module")
def problem():
    """Two coordinate sets on the unit square that share 20 points (exact
    zeros in the cross block), residuals and measurement variances, in both
    packages' containers."""
    rng = np.random.default_rng(3)
    c1 = rng.uniform(0, 1, (60, 2))
    c2 = np.concatenate([c1[:20], rng.uniform(0, 1, (35, 2))])
    z = rng.normal(size=115)
    mvar = np.abs(z) * 0.01 + 0.005
    jd = JN.joint_distance_blocks([jnp.asarray(c1), jnp.asarray(c2)], geodesic=False)
    td = TN.joint_distance_blocks([torch.as_tensor(c1), torch.as_tensor(c2)], geodesic=False)
    return jd, td, z, mvar


def test_distance_blocks_match_jax(problem):
    jd, td, _, _ = problem
    for i in range(2):
        for j in range(2):
            np.testing.assert_allclose(td[i][j].numpy(), np.asarray(jd[i][j]), rtol=0, atol=1e-15)
    assert int((td[0][1] == 0).sum()) == 20


@pytest.mark.parametrize("with_mvar", [False, True])
@pytest.mark.parametrize("analytic", [True, False])
def test_value_and_gradient_match_jax(problem, analytic, with_mvar):
    """Value rtol 1e-9 (the JAX suite's bar against its numpy oracle),
    gradient rtol 1e-6 / atol 1e-9, on both gradient branches."""
    jd, td, z, mvar = problem
    # the JAX reference jitted: op by op it took ~40 s of the CPU run here
    jv, jg = jax.jit(jax.value_and_grad(lambda x, m: JN.neg_log_likelihood(
        x, jd, jnp.asarray(z), JSPEC, m, 1e-8, analytic_grad=analytic)))(
        jnp.asarray(FLAT), jnp.asarray(mvar) if with_mvar else None)
    x = torch.tensor(FLAT, requires_grad=True)
    tv = TN.neg_log_likelihood(
        x, td, torch.as_tensor(z), TSPEC, torch.as_tensor(mvar) if with_mvar else None,
        1e-8, analytic_grad=analytic,
    )
    (tg,) = torch.autograd.grad(tv, x)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("with_mvar", [False, True])
def test_analytic_gradient_equals_plain_ad(problem, with_mvar):
    """Inside the port the closed-form d(nll)/dC path agrees with reverse
    mode through the factorization (the JAX suite's bar, rtol 1e-7)."""
    _, td, z, mvar = problem
    mv = torch.as_tensor(mvar) if with_mvar else None
    out = []
    for analytic in (True, False):
        x = torch.tensor(FLAT, requires_grad=True)
        v = TN.neg_log_likelihood(x, td, torch.as_tensor(z), TSPEC, mv, 1e-8,
                                  analytic_grad=analytic)
        out.append((v.item(), torch.autograd.grad(v, x)[0].numpy()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-12)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-7, atol=1e-10)


@pytest.fixture(scope="module")
def non_pd(problem):
    """rho = 1 with colocated samples and no nugget, and the reference's
    value there (computed once for the three cases, jitted: op by op it
    took ~10 s of the CPU run)."""
    jd, _, z, _ = problem
    bad = FLAT.copy()
    bad[[8, 9, 10]] = [0.0, 0.0, 1.0]
    return bad, float(jax.jit(lambda x: JN.neg_log_likelihood(
        x, jd, jnp.asarray(z), JSPEC, None, 0.0, analytic_grad=True))(jnp.asarray(bad)))


@pytest.mark.parametrize("analytic", [True, False, None])
def test_non_pd_point_gives_penalty_and_zero_gradient(problem, non_pd, analytic):
    """rho = 1 with colocated samples and no nugget: the value is the
    reference's penalty and the gradient exactly zero (``None`` takes the
    size gate: n = 115 -> plain AD)."""
    _, td, z, _ = problem
    bad, want = non_pd
    x = torch.tensor(bad, requires_grad=True)
    v = TN.neg_log_likelihood(x, td, torch.as_tensor(z), TSPEC, None, 0.0, analytic_grad=analytic)
    (g,) = torch.autograd.grad(v, x)
    assert v.item() == want == 1e6 * (1.0 + 0.5 * 115)
    assert torch.equal(g, torch.zeros_like(g))
    v2, g2 = TN.nll_value_and_grad(torch.as_tensor(bad), td, torch.as_tensor(z), TSPEC, None, 0.0)
    assert v2.item() == v.item() and torch.equal(g2, torch.zeros_like(g2))


def test_default_gate_is_the_reference_size_rule(problem, monkeypatch):
    """n <= 4096 differentiates through the factorization, n > 4096 takes
    the analytic Function."""
    _, td, z, _ = problem
    calls = []
    orig = TN._GaussianNll.apply
    monkeypatch.setattr(TN._GaussianNll, "apply", lambda *a: calls.append(1) or orig(*a))
    TN.neg_log_likelihood(torch.as_tensor(FLAT), td, torch.as_tensor(z), TSPEC)
    assert not calls
    TN.neg_log_likelihood(torch.as_tensor(FLAT), td, torch.as_tensor(z), TSPEC, analytic_grad=True)
    assert calls


def test_value_and_grad_helpers_match_jax(problem):
    """``nll_value_and_grad`` and its sigmoid-box twin against the
    reference's jitted pair."""
    jd, td, z, mvar = problem
    jv, jg = JN._nll_value_and_grad(jnp.asarray(FLAT), jd, jnp.asarray(z), JSPEC,
                                    jnp.asarray(mvar), 1e-8)
    tv, tg = TN.nll_value_and_grad(torch.as_tensor(FLAT), td, torch.as_tensor(z), TSPEC,
                                   torch.as_tensor(mvar), 1e-8)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)

    # bounds matched to the unit-square domain (the default km-scale
    # length-scale bounds do not contain FLAT)
    kw = dict(n_procs=2, sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0),
              nugget_bounds=(0.0, 0.5))
    jspec, tspec = type(JSPEC)(**kw), type(TSPEC)(**kw)
    lo, hi = jspec.bounds()
    frac = (FLAT - lo) / (hi - lo)
    u = np.log(frac) - np.log1p(-frac)
    assert np.isfinite(u).all()
    jv, jg = JN._nll_u_value_and_grad(jnp.asarray(u), jnp.asarray(lo), jnp.asarray(hi), jd,
                                      jnp.asarray(z), jspec, None, 1e-8)
    tv, tg = TN.nll_u_value_and_grad(torch.as_tensor(u), torch.as_tensor(lo), torch.as_tensor(hi),
                                     td, torch.as_tensor(z), tspec, None, 1e-8)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)


def test_f32_value_tracks_f64(problem):
    _, td, z, _ = problem
    td32 = [[b.float() for b in row] for row in td]
    v32 = TN.neg_log_likelihood(torch.as_tensor(FLAT).float(), td32, torch.as_tensor(z).float(),
                                TSPEC, None, 1e-4)
    v64 = TN.neg_log_likelihood(torch.as_tensor(FLAT), td, torch.as_tensor(z), TSPEC, None, 1e-4)
    assert v32.dtype == torch.float32
    np.testing.assert_allclose(v32.item(), v64.item(), rtol=1e-4)
