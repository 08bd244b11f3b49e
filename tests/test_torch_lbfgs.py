"""The port's on-device L-BFGS against the JAX package on cheap analytic
objectives, and the port's fitters that stand on it against its scipy
fits."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.estimate import nll as JN
from cokriging_tpu_torch.cov.matern import MultivariateMatern, matern_correlation
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate import empirical as TE, nll as TN, wls as TW
from cokriging_tpu_torch.fields.field import Field, MultiField

torch.set_num_threads(1)

_A = np.diag([1.0, 10.0, 100.0, 3.0])
_A[0, 1] = _A[1, 0] = 2.0
_B = np.array([0.3, -1.0, 2.0, 0.5])
_T = np.array([0.2, 0.9, 0.4, 0.6])


def _quad(x, xp):
    """A tilted quadratic whose minimizer lies on the box's boundary."""
    d = x - xp.asarray(_T)
    return 0.5 * d @ xp.asarray(_A) @ d + xp.asarray(_B) @ d


def _rosen(x, xp):
    return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


CASES = {
    "quadratic": (_quad, np.full(4, 0.5), np.zeros(4), np.ones(4)),
    "rosenbrock": (_rosen, np.array([-1.2, 1.0, 0.3]), np.full(3, -2.0), np.full(3, 2.0)),
}


@pytest.mark.parametrize("n_starts", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lbfgs_matches_jax_step_for_step(case, n_starts):
    """Same start, same minimizer to 1e-6, same evaluation count and
    ``converged``; with three starts, the same basin."""
    fn, x0, lo, hi = CASES[case]
    jx, jv, jn, jc = JN.sigmoid_box_lbfgs(
        lambda x: fn(x, jnp), jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi), n_starts=n_starts
    )
    tx, tv, tn, tc = TN.sigmoid_box_lbfgs(
        lambda x: fn(x, torch), torch.as_tensor(x0), torch.as_tensor(lo), torch.as_tensor(hi),
        n_starts=n_starts,
    )
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-9, atol=1e-12)
    assert tn == int(jn)
    assert tc == bool(jc)


def test_restart_beats_the_callers_basin_only_by_a_margin():
    """A double well: the caller's start falls into the shallow basin, a
    box-fraction restart into the deep one, and the restart wins; with the
    wells level to within the 0.1% margin the caller's basin is kept."""
    lo, hi = torch.tensor([-2.0]), torch.tensor([2.0])

    def well(tilt):
        return lambda x: ((x**2 - 1.0) ** 2 + tilt * x).sum() + 5.0

    x, _, _, conv = TN.sigmoid_box_lbfgs(well(0.3), torch.tensor([0.9]), lo, hi, n_starts=3)
    assert conv and x.item() < -0.9
    x, _, _, conv = TN.sigmoid_box_lbfgs(well(1e-4), torch.tensor([0.9]), lo, hi, n_starts=3)
    assert conv and x.item() > 0.9


def test_penalty_plateau_is_not_converged():
    """A start stranded where the cleaned gradient is exactly zero reports
    converged=False."""
    x, v, n, conv = TN.sigmoid_box_lbfgs(
        lambda x: (x * 0.0).sum() + 7.0, torch.tensor([0.5, 0.5], dtype=torch.float64),
        torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64),
    )
    assert not conv and float(v) == 7.0 and n == 1


def _gp_fields(n=60, seed=5):
    """Two correlated Matern (nu = 1) fields with a nugget on the unit
    square."""
    rng = np.random.default_rng(seed)
    c1, c2 = rng.uniform(0, 1, (n, 2)), rng.uniform(0, 1, (n, 2))
    c = np.concatenate([c1, c2])
    d = np.sqrt(((c[:, None] - c[None]) ** 2).sum(-1))
    rho = np.where(np.arange(2 * n)[:, None] // n == np.arange(2 * n)[None] // n, 1.0, -0.3)
    cov = rho * matern_correlation(1.0, 0.2, torch.as_tensor(d)).numpy() + 0.1 * np.eye(2 * n)
    z = np.linalg.cholesky(cov) @ rng.normal(size=2 * n)
    return MultiField(fields=[Field.from_arrays(c1, z[:n], "Z0"), Field.from_arrays(c2, z[n:], "Z1")])


def _unit_square_init():
    """A start and a box matched to the unit square. The box keeps every
    model valid (near-common nu and length scale, |rho| <= 0.8) and nu off
    the half-integers: the free bivariate Matern otherwise walks along its
    non-PD wall, where no two optimizers take the same path."""
    spec = ParamSpec(n_procs=2, sigma_bounds=(0.1, 3.0), nu_bounds=(0.9, 1.1),
                     len_scale_bounds=(0.1, 0.3), nugget_bounds=(0.0, 0.5),
                     rho_bounds=(-0.8, 0.8))
    flat = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 0.15, 0.15, 0.15, 0.05, 0.05, 0.0],
                        dtype=torch.float64)
    return MaternParams.from_flat(flat, spec=spec)


def test_fit_nll_device_lbfgs_reaches_scipy_optimum():
    """On-device L-BFGS against the host scipy fit at 2 x 60 points, at
    the bar the JAX suite holds its own pair to."""
    mf, init = _gp_fields(), _unit_square_init()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p_h, info_h = TN.fit_nll(mf, init=init, jitter=1e-8, maxiter=100, device="cpu")
    p_d, info_d = TN.fit_nll_device(mf, init=init, jitter=1e-8, maxiter=100, method="lbfgs",
                                    device="cpu")
    assert info_d["success"] and info_h["success"]
    assert info_d["nll"] <= info_h["nll"] + 0.05 * abs(info_h["nll"]) + 0.5
    assert set(info_d) == set(info_h) == {"nll", "success", "n_iter", "n_obj_evals"}
    x0 = init.to_flat()
    dists = TN.joint_distance_blocks([f.coords_main for f in mf.fields], geodesic=False)
    z = torch.cat([f.values_main for f in mf.fields])
    start = TN.neg_log_likelihood(x0, dists, z, init.spec, None, 1e-8).item()
    assert info_d["nll"] < start and info_h["nll"] < start
    lo, hi = init.spec.bounds()
    for p in (p_h, p_d):
        x = p.to_flat().numpy()
        assert np.all((x >= lo) & (x <= hi))
    # the fitted value is the NLL at the fitted parameters
    again = TN.neg_log_likelihood(p_d.to_flat(), dists, z, init.spec, None, 1e-8).item()
    np.testing.assert_allclose(again, info_d["nll"], rtol=1e-9)


def test_fit_nll_device_adam_improves_on_init():
    mf, init = _gp_fields(), _unit_square_init()
    dists = TN.joint_distance_blocks([f.coords_main for f in mf.fields], geodesic=False)
    z = torch.cat([f.values_main for f in mf.fields])
    start = TN.neg_log_likelihood(init.to_flat(), dists, z, init.spec, None, 1e-8).item()
    params, info = TN.fit_nll_device(mf, init=init, maxiter=40, method="adam", device="cpu")
    assert info["success"] and info["n_iter"] == 40
    assert info["nll"] < start
    with pytest.raises(ValueError):
        TN.fit_nll_device(mf, init=init, method="newton", device="cpu")


def test_fit_wls_lbfgs_reaches_scipy_cost():
    rng = np.random.default_rng(11)
    cs, vs = [], []
    for k in range(2):
        lat, lon = rng.uniform(24, 50, 300), rng.uniform(-124, -67, 300)
        s = np.sin(np.deg2rad(lat) * 6.0) + 0.5 * np.cos(np.deg2rad(lon) * 4.0)
        cs.append(np.column_stack([lat, lon]))
        vs.append((1 - 1.6 * k) * s + rng.normal(scale=0.4, size=300))
    cfg = TE.VarioConfig(max_dist=3000.0, n_bins=15)
    pairs, c, m, n = TE.empirical_variograms_device(cs, vs, cfg, device="cpu")
    est = TE.EmpiricalVariogram(cfg, pairs, c, m, n)
    init = TW.moment_init(est)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, res_s = TW.fit_wls(est, init=init, method="scipy", device="cpu")
    p_l, res_l = TW.fit_wls(est, init=init, method="lbfgs", maxiter=300, device="cpu")
    assert res_l.success
    assert res_l.cost <= res_s.cost * (1.0 + 1e-4)
    assert MultivariateMatern(params=p_l).n_procs == 2
