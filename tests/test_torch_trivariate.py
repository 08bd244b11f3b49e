"""The port at p = 3 (``experiments/trivariate_demo.py``) against the JAX
package, on the CPU in float64: the p-wide reference draws (the JAX
simulator's normals, its sample locations and noise, its cofield), the six
(cross-)variograms, the moment initializer, the 21-parameter WLS cost and
gradient (at the demo's estimate and at tests/test_trivariate.py's recovery
estimate), the recovery draws, the 3 x 3-block joint predictor and the p = 1
baseline, the local predictor's mixed-process lanes against the joint
solution, and ``main`` at cut demo sizes. The recovery's fit and its gates
run on the card (chip_smoke (q)): its 400-iteration fit costs ~25 s on this
CPU's plain K_nu."""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams
from cokriging_tpu.cov import MultivariateMatern as JMod
from cokriging_tpu.cov.matern import block_covariance as j_block_covariance
from cokriging_tpu.cov.matern import cross_semivariance as j_cross_semivariance
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate import VarioConfig as JVarioConfig
from cokriging_tpu.estimate import empirical_variograms as j_empirical_variograms
from cokriging_tpu.estimate import wls as JW
from cokriging_tpu.fields.field import Field as JField
from cokriging_tpu.fields.field import MultiField as JMultiField
from cokriging_tpu.predict import JointPredictor as JJoint
from cokriging_tpu.sim import CartesianGrid as JGrid
from cokriging_tpu.sim import MultivariateRandomField as JRandomField
from cokriging_tpu_torch.cov.matern import cross_semivariance
from cokriging_tpu_torch.estimate import wls as TW
from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
from cokriging_tpu_torch.experiments import reference_draws as RD
from cokriging_tpu_torch.experiments import trivariate_demo as T
from cokriging_tpu_torch.fields.field import MultiField
from cokriging_tpu_torch.predict.joint import JointPredictor
from cokriging_tpu_torch.predict.local import LocalPredictor

torch.set_num_threads(2)

GRID, SIZE = 15, 40  # the comparisons' cofield: 3 x 225 cells, 40 samples per process
JSPEC3 = JSpec(n_procs=3, **T.BOUNDS)
CPU = torch.device("cpu")
# main at cut demo sizes (the demo's 41 x 41 cofield and its 400-iteration
# fit cost minutes on this CPU's plain K_nu)
MAIN_SIZES = dict(grid=19, size=110, maxiter=30, local=1)


def _ulps(a, b):
    return np.abs(a.view(np.int64) - b.view(np.int64))


@pytest.fixture(scope="module")
def fields():
    """The port's and the JAX package's cofield on the GRID x GRID grid
    (seed 11), and the port's sample of SIZE per process (seed 11,
    eps 0.1)."""
    model, rf, spec = T.simulate(GRID, CPU)
    jtruth = JParams.from_flat(jnp.asarray(np.array(T.TRUTH)), spec=JSPEC3)
    jrf = JRandomField(JMod(params=jtruth), JGrid(xcount=GRID, ycount=GRID), seed=T.SEEDS[0])
    samples = rf.sample(size=SIZE, epsilon=(T.EPS,))
    return model, rf, spec, jrf, samples


@pytest.fixture(scope="module")
def estimates(fields):
    """The six variograms of the port's sample in both packages."""
    _, rf, _, _, samples = fields
    mf = rf.to_fields(samples)
    est = empirical_variograms(mf, VarioConfig(max_dist=T.MAX_DIST, n_bins=T.N_BINS, geodesic=False),
                               device="cpu")
    jmf = JMultiField(fields=[JField.from_arrays(f.coords.numpy(), f.values.numpy(), f.name)
                              for f in mf.fields])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jest = j_empirical_variograms(jmf, JVarioConfig(max_dist=T.MAX_DIST, n_bins=T.N_BINS, geodesic=False))
    return est, jest, mf, jmf


@pytest.fixture(scope="module")
def demo_run():
    """``main("cpu")`` once, at ``MAIN_SIZES``, recording nothing."""
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        mp.setenv("COKRIGING_NO_RECORD", "1")
        mp.delenv("TRIVARIATE_DEMO_LOCAL", raising=False)
        return T.main("cpu", **MAIN_SIZES)


def _jax_recovery_draws(grid_n):
    """tests/test_trivariate.py's ``tri_sim`` on a grid_n x grid_n grid: the
    JAX package's 3 x 3-block covariance of the truth (under ``jax.jit``,
    half the time of the test's eager call here), numpy's Cholesky factor and
    its four draws of seed 7: (coordinates, [[z0, z1, z2] per draw])."""
    truth = JParams.from_flat(jnp.asarray(np.array(T.TRUTH)), spec=JSPEC3)
    grid = JGrid(xcount=grid_n, ycount=grid_n)
    d, n = grid.dist, grid.count
    cov = jax.jit(lambda p, d: j_block_covariance(p, [[d, d, d]] * 3, h_grad=False))(truth, d)
    chol = np.linalg.cholesky(np.asarray(cov))
    rng = np.random.default_rng(T.RECOVERY_SEED)
    reps = []
    for _ in range(T.RECOVERY_REPS):
        z = chol @ rng.normal(size=3 * n)
        reps.append([z[:n], z[n: 2 * n], z[2 * n:]])
    return np.column_stack([grid.coords["x"].values, grid.coords["y"].values]), reps


def _jax_pooled(coords, reps):
    """The JAX package's six variograms of each draw (tests/test_trivariate.py's
    config: 12 bins to 0.5, Euclidean fields), pooled."""
    cfg = JVarioConfig(max_dist=T.RECOVERY_MAX_DIST, n_bins=T.N_BINS, geodesic=False)
    ests = []
    for zs in reps:
        fields = [JField.from_arrays(coords, z, f"Z{k}") for k, z in enumerate(zs)]
        for f in fields:
            f.geodesic = False
        ests.append(j_empirical_variograms(JMultiField(fields=fields), cfg))
    return T.pool(ests)


RECOVERY_TEST_GRID = 9  # the recovery's data on a 9 x 9 grid (its 31 x 31 runs on the card)


@pytest.fixture(scope="module")
def recovery_estimates():
    """``recovery_draws`` and ``recovery_estimate`` with ``RECOVERY_GRID``
    set to RECOVERY_TEST_GRID, tests/test_trivariate.py's draws there from the
    JAX package's covariance, and the JAX package's pooled estimate of the
    port's draws: (coordinates, draws, estimate, JAX coordinates, JAX
    draws, JAX estimate)."""
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        mp.setattr(T, "RECOVERY_GRID", RECOVERY_TEST_GRID)
        coords, reps = T.recovery_draws(CPU)
        est = T.recovery_estimate(CPU)
        jcoords, jreps = _jax_recovery_draws(RECOVERY_TEST_GRID)
        jest = _jax_pooled(coords, reps)
    return coords, reps, est, jcoords, jreps, jest


# --- the draws ---------------------------------------------------------------


def test_field_normals_are_the_jax_simulators(fields):
    """The cofield's (p n,) normals within 2 ulp of ``jax.random.normal``
    (PRNGKey(11), float64) and each process's sample noise of its split
    of PRNGKey(seed + 1). The draws are the demo's own (its seeds): the
    long-double multiply-adds put about 1 entry in 10^5 3 ulp off
    (``test_float64_normals_ulps_at_scale``), and none of these 1,035."""
    _, rf, _, _, _ = fields
    assert isinstance(rf, RD.ReferenceDrawField) and rf.n_procs == 3
    got = rf._field_noise().numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(T.SEEDS[0]), (3 * GRID * GRID,),
                                        jnp.float64))
    assert got.shape == want.shape and _ulps(got, want).max() <= 2
    for seed in T.SEEDS:
        noise = rf._sample_noise(seed + 1, SIZE)
        key = jax.random.PRNGKey(seed + 1)
        for i in range(3):
            key, sub = jax.random.split(key)
            assert _ulps(noise[i], np.asarray(jax.random.normal(sub, (SIZE,)))).max() <= 2


@pytest.mark.parametrize("seed", [0, 11])
def test_float64_normals_ulps_at_scale(seed):
    """``reference_draws.normal`` against ``jax.random.normal`` (float64)
    over 10^5 entries per seed: bit for bit in all but 1 in 10^3 (about 3.5
    in 10^4 differ: the fused multiply-adds round twice through long
    double where XLA's round once), and none more than 3 ulp apart."""
    n = 100_000
    u = _ulps(RD.normal(RD.prng_key(seed), n),
              np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float64)))
    counts = np.bincount(u, minlength=4)
    print(f"seed {seed}: entries 0 / 1 / 2 / 3 ulp apart: {counts.tolist()}")
    assert u.max() <= 3 and (u > 0).mean() <= 1e-3, counts.tolist()


@pytest.mark.parametrize("size,seed", [(SIZE, 11), (61, 12), (56, 13)])
def test_sample_locations_are_the_jax_simulators(fields, size, seed):
    """The semi-colocated split at p = 3: the JAX simulator's indices, the
    first ceil(size / 2) shared by all three processes."""
    _, rf, _, jrf, _ = fields
    got = rf._split_samp_coords(size, seed)
    want = JRandomField._split_samp_coords(types.SimpleNamespace(
        n_procs=3, grid=types.SimpleNamespace(count=GRID * GRID)), size, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    n_co = -(-size // 2)
    assert all(np.array_equal(got[0][:n_co], g[:n_co]) for g in got)
    assert not (set(got[0][n_co:]) & set(got[1][n_co:])) and not (set(got[1][n_co:]) & set(got[2][n_co:]))


def test_cofield_and_samples_match_jax(fields):
    """The 3 x 3-block cofield (block covariance, one Cholesky, the JAX
    normals) and its sample equal the JAX simulator's up to the factors'
    rounding."""
    _, rf, _, jrf, samples = fields
    for i in range(3):
        np.testing.assert_allclose(rf.fields[i]["value"].values, jrf.fields[i]["value"].values,
                                   rtol=0, atol=1e-12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsamples = jrf.sample(size=SIZE, epsilon=(T.EPS,))
    for s, js in zip(samples, jsamples):
        np.testing.assert_array_equal(s[["x", "y"]].values, js[["x", "y"]].values)
        np.testing.assert_allclose(s.iloc[:, 2].values, js.iloc[:, 2].values, rtol=0, atol=1e-12)


# --- variograms, moment init, the WLS cost ----------------------------------


def test_six_variograms_match_jax(estimates):
    est, jest, _, _ = estimates
    assert est.config.n_procs == jest.config.n_procs == 3
    assert est.pairs == list(jest.pairs) == [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    np.testing.assert_array_equal(est.bin_counts, np.asarray(jest.bin_counts))
    np.testing.assert_allclose(est.bin_centers, np.asarray(jest.bin_centers), rtol=1e-12)
    np.testing.assert_allclose(est.bin_means, np.asarray(jest.bin_means), rtol=1e-12)


def test_moment_init_matches_jax(estimates):
    est, jest, _, _ = estimates
    got = TW.moment_init(est, spec=_spec3()).to_flat().numpy()
    want = np.asarray(JW.moment_init(jest, spec=JSPEC3).to_flat())
    assert got.shape == (21,)
    np.testing.assert_allclose(got, want, rtol=1e-13)


def _spec3():
    from cokriging_tpu_torch.cov.params import ParamSpec

    return ParamSpec(n_procs=3, **T.BOUNDS)


@pytest.mark.parametrize("where", ["init", "truth", "off half-integers", "recovery init"])
def test_wls_cost_and_gradient_match_jax(request, where):
    """The composite WLS cost over the six groups (the pair sill, the
    (7, n_pairs) flat positions) and its gradient in all 21 parameters, on
    the demo's estimate and (at its moment initializer, where ``fit``
    starts) on the recovery's."""
    if where == "recovery init":
        *_, est, _, _, jest = request.getfixturevalue("recovery_estimates")
    else:
        est, jest, _, _ = request.getfixturevalue("estimates")
    x = np.asarray(JW.moment_init(jest, spec=JSPEC3).to_flat()).copy()
    if where == "truth":
        x = np.array(T.TRUTH)
    elif where == "off half-integers":
        x[3:9] = [1.3, 0.9, 1.7, 1.1, 2.2, 0.7]
        x[18:] = [-0.3, 0.25, 0.1]
    jv, jg = JW._cost_and_grad(jnp.asarray(x), jnp.asarray(jest.bin_centers),
                               jnp.asarray(jest.bin_means),
                               jnp.asarray(jest.bin_counts, jnp.float64), tuple(jest.pairs), JSPEC3)
    xt = torch.tensor(x, requires_grad=True)
    tv = TW.composite_wls_cost(xt, torch.as_tensor(est.bin_centers), torch.as_tensor(est.bin_means),
                               torch.as_tensor(est.bin_counts).double(), tuple(est.pairs), _spec3())
    (tg,) = torch.autograd.grad(tv, xt)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-10)


def test_recovery_draws_and_estimate_match_jax(recovery_estimates):
    """``recovery_draws`` and ``recovery_estimate`` on a 9 x 9 grid (the
    31 x 31 covariance costs ~20 s on this CPU's plain K_nu; the card runs
    it in chip_smoke (q)) against tests/test_trivariate.py's draws from the
    JAX package's covariance (atol 1e-12) and the JAX package's pooled
    variograms of the same draws (counts equal, means rtol 1e-12)."""
    coords, reps, est, jcoords, jreps, jest = recovery_estimates
    np.testing.assert_array_equal(coords, jcoords)
    assert len(reps) == T.RECOVERY_REPS
    for zs, jzs in zip(reps, jreps):
        np.testing.assert_allclose(np.asarray(zs), np.asarray(jzs), rtol=0, atol=1e-12)
    assert est.pairs == list(jest.pairs) and est.config.max_dist == T.RECOVERY_MAX_DIST
    np.testing.assert_array_equal(est.bin_counts, np.asarray(jest.bin_counts))
    np.testing.assert_allclose(est.bin_means, np.asarray(jest.bin_means), rtol=1e-12)


def test_cross_semivariance_uses_the_pair_sill_like_jax(fields):
    """tests/test_trivariate.py:75 at p = 3: the far-field cross
    semivariogram is the pair's sill, as the JAX package's."""
    model, _, _, jrf, _ = fields
    h = [0.0, 0.05, 0.3, 1e9]
    for i, j in ((0, 1), (0, 2), (1, 2)):
        got = cross_semivariance(model.params, i, j, torch.tensor(h, dtype=torch.float64)).numpy()
        want = np.asarray(j_cross_semivariance(jrf.mod.params, i, j, jnp.asarray(h)))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)
    assert abs(got[-1] - 0.5 * (2.0 + 0.05 + 0.05)) < 1e-12


# --- prediction --------------------------------------------------------------


def test_joint_predictor_p3_and_p1_match_jax(fields, estimates):
    """The 3 x 3-block joint predictor of process 1 and the p = 1
    baseline on its own data: predictions atol 1e-8, kriging variances
    atol 1e-10 (cells on a datum of process 1 have a variance of zero up to
    round-off, whose square root differs by ~1e-8 between the packages)."""
    model, rf, _, jrf, _ = fields
    _, _, mf, jmf = estimates
    pc = rf.coords.values[::7]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = JointPredictor(model, mf, device="cpu")(1, pc, postprocess=False)
        want = JJoint(jrf.mod, jmf)(1, pc, postprocess=False)
        uni = JointPredictor(T.univariate_model(model.params), MultiField(fields=[mf.fields[1]]),
                             device="cpu")(0, pc, postprocess=False)
        juni_params = JParams.default(1).with_flat(jnp.asarray([1.0, 1.5, 0.2, 0.05]))
        juni = JJoint(JMod(params=juni_params), JMultiField(fields=[jmf.fields[1]]))(
            0, pc, postprocess=False)
    for a, b in ((got, want), (uni, juni)):
        np.testing.assert_allclose(a.pred, np.asarray(b["pred"]), rtol=0, atol=1e-8)
        np.testing.assert_allclose(a.pred_err**2, np.asarray(b["pred_err"]) ** 2, rtol=0, atol=1e-10)
    assert np.isfinite(got.pred).all() and not np.allclose(got.pred, uni.pred)


@pytest.mark.parametrize("i", [0, 1, 2])
@pytest.mark.parametrize("materialize_cov", [True, False])
def test_local_predictor_p3_covering_every_datum_is_the_joint_solution(fields, estimates, i,
                                                                         materialize_cov):
    """At a radius that covers every datum each neighbourhood holds all
    three processes' data, so the local system is the joint one: the
    own / cross lanes of ``_prediction_cov`` and the gathered 3 x 3
    blocks must give the joint predictor's answer (atol 1e-8)."""
    model, rf, _, _, _ = fields
    _, _, mf, _ = estimates
    pc = rf.coords.values[3::11]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        joint = JointPredictor(model, mf, device="cpu")(i, pc, postprocess=False)
        local = LocalPredictor(model, mf, device="cpu", materialize_cov=materialize_cov)(
            i, pc, max_dist=2.0, postprocess=False)
    assert (local.n_neighbors == 3 * SIZE).all()
    np.testing.assert_allclose(local.pred, joint.pred, rtol=0, atol=1e-8)
    np.testing.assert_allclose(local.pred_err**2, joint.pred_err**2, rtol=0, atol=1e-10)


# --- main --------------------------------------------------------------------


def test_main_passes_the_demo_gates(demo_run):
    """``main("cpu")`` at cut sizes: every prediction gate holds (the demo's
    MSPE gate, the joint and local prediction gates of
    tests/test_trivariate.py), and the record carries the demo's stages,
    its 21-parameter fit and where that fit stands against the test's
    bars."""
    r = demo_run
    assert all(r["gates"].values()) and len(r["gates"]) == 4, r["gates"]
    assert r["sizes"] == {**T.CPU_SIZES, **MAIN_SIZES} and r["dtype"] == "float64"
    assert r["mspe_tri"] <= 1.02 * r["mspe_uni"] and r["local_vs_joint_msd"] < 1e-4
    assert set(r["stage_s"]) == {"simulate", "variograms", "fit_wls", "joint_prediction",
                                 "univariate_baseline", "local_prediction"}
    assert len(r["fitted_flat"]) == 21 and len(r["init_flat"]) == 21
    assert set(r["demo_fit_against_test_bars"]) == {"rho signs", "rho within 0.25", "sigma within 0.3 of 1",
                                                    "diagonal length scales within 0.1 of 0.2"}


def test_sizes_and_the_local_knob(monkeypatch):
    """The script's sizes on both devices; ``TRIVARIATE_DEMO_LOCAL`` sets
    ``local`` and a keyword overrides it; an unknown size is refused."""
    cuda = types.SimpleNamespace(type="cuda")
    assert T.sizes_for(CPU)["local"] == 0 and T.sizes_for(cuda) == T.CARD_SIZES
    assert T.CARD_SIZES["grid"] == 41 and T.CARD_SIZES["size"] == 280
    monkeypatch.setenv("TRIVARIATE_DEMO_LOCAL", "1")
    assert T.sizes_for(cuda)["local"] == 1 and T.sizes_for(CPU, local=0)["local"] == 0
    with pytest.raises(TypeError):
        T.sizes_for(CPU, grids=3)
