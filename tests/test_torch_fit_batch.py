"""The port's batched WLS fits against the JAX package, on the CPU in float64:
the batched L-BFGS (``estimate.nll.sigmoid_box_lbfgs_batch`` under
``make_device_wls_fitter``) per member against the single instance and
against the JAX package's vmapped fitter, ``fit_wls_batch`` with its
options, and the Adam fitter. The fits are three months of a simulated
cofield (tests/test_fit_batch.py's), 40 evaluations per start: beyond that
these stiff fits are still far from converged, and the trajectories of the
two packages, whose K_nu round differently in the last place, part."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams, MultivariateMatern as JMod
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate import VarioConfig as JConfig, empirical_variograms as jemp
from cokriging_tpu.estimate import wls as JW
from cokriging_tpu.sim import BivariateRandomField as JField, CartesianGrid as JGrid
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate import empirical as TE, nll as TN, wls as TW

torch.set_num_threads(1)

SIM_FLAT = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.0, 0.0, -0.6]
BOUNDS = dict(sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0), nugget_bounds=(0.0, 0.5))
# off the half-integer orders, where the reference's CF2 dK/dnu jumps
INIT = np.array([1.0, 1.0, 1.3, 1.2, 1.1, 0.1, 0.1, 0.1, 0.01, 0.01, 0.0])
MAXITER = 40


@pytest.fixture(scope="module")
def months():
    """Three months' variograms, estimated by the JAX package, in both
    packages' containers, and their stacked (B, n_pairs, n_bins) arrays."""
    mod = JMod(params=JParams.from_flat(jnp.asarray(SIM_FLAT)))
    grid = JGrid(xcount=17, ycount=17)
    jests = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for seed in range(3):
            rf = JField(mod, grid, seed=seed)
            mf = rf.to_fields(rf.sample(size=60, epsilon=[0.1, 0.1], seed=seed + 10))
            jests.append(jemp(mf, JConfig(1.0, 8, geodesic=False)))
    cfg = TE.VarioConfig(1.0, 8, geodesic=False)
    tests = [TE.EmpiricalVariogram(cfg, list(e.pairs), np.asarray(e.bin_centers),
                                   np.asarray(e.bin_means), np.asarray(e.bin_counts))
             for e in jests]
    arrays = (np.stack([e.bin_centers for e in tests]),
              np.nan_to_num(np.stack([e.bin_means for e in tests]), nan=0.0),
              np.stack([e.bin_counts for e in tests]).astype(np.float64))
    return jests, tests, arrays, tuple(tests[0].pairs)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_batched_lbfgs_each_member_equals_its_fit_alone(months):
    """All 3 x 3 members step together, and each ends where its fit alone
    ends: the same x, cost, evaluations and verdict (a member's arithmetic
    does not depend on the batch)."""
    _, _, (c, m, n), pairs = months
    fit = TW.make_device_wls_fitter(pairs, ParamSpec(2, **BOUNDS), MAXITER)
    x0 = np.stack([INIT, INIT * 1.1, INIT * 0.9])
    xb, vb, eb, cb = fit(*_t(x0, c, m, n))
    for b in range(3):
        x1, v1, e1, c1 = fit(*_t(x0[b], c[b], m[b], n[b]))
        np.testing.assert_allclose(xb[b].numpy(), x1.numpy(), rtol=1e-10, atol=0)
        assert float(vb[b]) == pytest.approx(float(v1), rel=1e-12)
        assert int(eb[b]) == int(e1) and bool(cb[b]) == bool(c1)


def test_batched_lbfgs_on_an_analytic_objective():
    """Rows of tilted quadratics and Rosenbrock valleys, each its own
    target: every member converges to its own minimizer and equals its run
    alone bit for bit; members stop at different iterations and stay
    frozen after."""
    rng = np.random.default_rng(3)
    targets = torch.as_tensor(rng.uniform(0.2, 0.8, (5, 4)))
    lo, hi = torch.zeros(4, dtype=torch.float64), torch.ones(4, dtype=torch.float64)

    def raw(x, rows):
        t = targets[rows]
        quad = ((x - t) ** 2 * torch.arange(1.0, 5.0, dtype=x.dtype)).unbind(-1)
        rosen = (100.0 * (x[:, 1] - x[:, 0] ** 2) ** 2 + (1.0 - x[:, 0]) ** 2) * (rows == 4)
        return quad[0] + quad[1] + quad[2] + quad[3] + rosen

    x0 = torch.full((5, 4), 0.5, dtype=torch.float64)
    xb, vb, eb, cb = TN.sigmoid_box_lbfgs_batch(raw, x0, lo, hi, maxiter=150, n_starts=2)
    assert len(set(eb.tolist())) > 1
    for b in range(5):
        x1, v1, e1, c1 = TN.sigmoid_box_lbfgs_batch(
            lambda x, rows: raw(x, rows + b), x0[b:b + 1], lo, hi, maxiter=150, n_starts=2)
        assert torch.equal(xb[b], x1[0]) and torch.equal(vb[b], v1[0])
        assert int(eb[b]) == int(e1[0]) and bool(cb[b]) == bool(c1[0])
    np.testing.assert_allclose(xb[:4].numpy(), targets[:4].numpy(), atol=1e-5)
    assert cb[:4].all()


def test_batched_fits_match_jax(months):
    """Per member the JAX package's vmapped fitter: x to 1e-6, the cost to
    1e-9, the same evaluations and verdict (tests/test_torch_lbfgs.py's bars
    for the single instance); ``fit_wls_batch_arrays`` returns the same."""
    _, _, (c, m, n), pairs = months
    x0 = np.stack([INIT, INIT * 1.1, INIT * 0.9])
    jfit = jax.jit(jax.vmap(JW.make_device_wls_fitter(pairs, JSpec(2, **BOUNDS), MAXITER)))
    jx, jv, je, jc = (np.asarray(a) for a in jfit(*(jnp.asarray(a) for a in (x0, c, m, n))))
    tx, tv, te, tc = TW.make_device_wls_fitter(pairs, ParamSpec(2, **BOUNDS), MAXITER)(
        *_t(x0, c, m, n))
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-9)
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_array_equal(tc.numpy(), jc)
    xs, costs, conv = TW.fit_wls_batch_arrays(x0, c, m, n, pairs, ParamSpec(2, **BOUNDS),
                                              maxiter=MAXITER, device="cpu")
    assert isinstance(xs, np.ndarray) and xs.shape == (3, 11)
    np.testing.assert_array_equal(xs, tx.numpy())
    np.testing.assert_array_equal(costs, tv.numpy())
    np.testing.assert_array_equal(conv, tc.numpy())


@pytest.fixture(scope="module")
def penalized(months):
    """``fit_wls_batch`` with the Cauchy-Schwarz penalty, unprojected, in
    both packages."""
    jests, tests, _, _ = months
    jinit = JParams.from_flat(jnp.asarray(INIT), spec=JSpec(2, **BOUNDS))
    tinit = MaternParams.from_flat(torch.as_tensor(INIT), spec=ParamSpec(2, **BOUNDS))
    kw = dict(maxiter=MAXITER, validity_weight=0.1)
    return JW.fit_wls_batch(jests, init=jinit, **kw), TW.fit_wls_batch(tests, init=tinit,
                                                                       device="cpu", **kw)


def test_fit_wls_batch_with_the_penalty_matches_jax(penalized):
    (jp, jc, jconv), (tp, tc, tconv) = penalized
    assert len(tp) == 3 and tc.shape == (3,) and tconv.dtype == bool
    for a, b in zip(tp, jp):
        assert a.sigma.dtype == torch.float64
        np.testing.assert_allclose(a.to_flat().numpy(), np.asarray(b.to_flat()), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-9)
    np.testing.assert_array_equal(tconv, np.asarray(jconv))


@pytest.mark.parametrize("project", [True, "parsimony"])
def test_fit_wls_batch_projections_match_jax(months, penalized, project, monkeypatch):
    """Each month's fit projected as the JAX package projects it; the flat
    vectors come from the penalized fits above (the fit itself is the same
    call)."""
    from cokriging_tpu.cov.spectral import project_to_valid

    _, tests, _, _ = months
    (jp, _, _), (tp, tc, tconv) = penalized
    xs = np.stack([p.to_flat().numpy() for p in tp])
    monkeypatch.setattr(TW, "fit_wls_batch_arrays", lambda *a, **k: (xs, tc, tconv))
    got, _, _ = TW.fit_wls_batch(tests, project_validity=project, device="cpu")
    for a, b in zip(got, jp):
        want = project_to_valid(b, parsimony=project == "parsimony")
        np.testing.assert_allclose(a.to_flat().numpy(), np.asarray(want.to_flat()), rtol=0,
                                   atol=1e-6)


def test_per_month_init_starts_from_each_months_moments(months):
    """Each month starts from its own ``moment_init``, the JAX package's to
    1e-13. Those starts sit at nu = 1.5, where the reference's CF2 dK/dnu
    jumps by up to ~2% across the order, so which side of it the box
    transform rounds to decides the fit in either package
    (tests/test_torch_wls.py): the fit is held to the port's own batched
    fit from those starts, not to the JAX package's trajectory."""
    jests, tests, (c, m, n), pairs = months
    spec = ParamSpec(2, **BOUNDS)
    x0 = np.stack([TW.moment_init(e, spec=spec).to_flat().numpy() for e in tests])
    for x, e in zip(x0, jests):
        np.testing.assert_allclose(x, np.asarray(JW.moment_init(e, spec=JSpec(2, **BOUNDS))
                                                 .to_flat()), rtol=1e-13)
    tp, tc, tconv = TW.fit_wls_batch(tests, init=MaternParams.default(spec=spec),
                                     maxiter=MAXITER, per_month_init=True, device="cpu")
    xs, costs, conv = TW.fit_wls_batch_arrays(x0, c, m, n, pairs, spec, maxiter=MAXITER,
                                              device="cpu")
    np.testing.assert_array_equal(np.stack([p.to_flat().numpy() for p in tp]), xs)
    np.testing.assert_array_equal(tc, costs)
    np.testing.assert_array_equal(tconv, conv)


def test_adam_fitter_batched_matches_jax_and_each_member(months):
    _, _, (c, m, n), pairs = months
    x0 = np.stack([INIT, INIT * 1.1, INIT * 0.9])
    steps = 25
    jfit = jax.jit(jax.vmap(JW.make_device_adam_fitter(pairs, JSpec(2, **BOUNDS), steps)))
    jx, jv = (np.asarray(a) for a in jfit(*(jnp.asarray(a) for a in (x0, c, m, n))))
    fit = TW.make_device_adam_fitter(pairs, ParamSpec(2, **BOUNDS), steps)
    tx, tv = fit(*_t(x0, c, m, n))
    np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6)
    x1, v1 = fit(*_t(x0[1], c[1], m[1], n[1]))
    np.testing.assert_allclose(x1.numpy(), tx[1].numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(v1), float(tv[1]), rtol=1e-12)


def test_mesh_is_not_ported_and_empty_batches(months):
    _, tests, (c, m, n), pairs = months
    with pytest.raises(ValueError, match="item 8"):
        TW.fit_wls_batch(tests, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="item 8"):
        TW.fit_wls_batch_arrays(INIT[None], c[:1], m[:1], n[:1], pairs, ParamSpec(),
                                mesh=object(), device="cpu")
    out = TW.fit_wls_batch([], device="cpu")
    assert out[0] == [] and out[1].shape == (0,)
