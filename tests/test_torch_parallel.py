"""The port's device mesh (``parallel/``) on the CPU in float64: eight
virtual shards of the CPU (``make_mesh(8, device="cpu")``) against the JAX
package's sharded functions on its eight virtual CPU devices
(``tests/conftest.py``), at the JAX tests' own setups
(``tests/test_parallel.py``, ``tests/test_vecchia_sharded.py``); ``mesh=``
in the fitters, the bootstrap and the CG predictor against the port's own
unsharded calls (bit-equal where a member's fit is its fit alone)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu import parallel as JP
from cokriging_tpu.cov import MaternParams as JParams, MultivariateMatern as JMod
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate import VarioConfig as JConfig, empirical_variograms as j_variograms
from cokriging_tpu.estimate.vecchia import VecchiaLikelihood as JVecchia
from cokriging_tpu.predict import LocalPredictor as JLocal
from cokriging_tpu.sim import BivariateRandomField as JField, CartesianGrid as JGrid
from cokriging_tpu_torch import parallel as P
from cokriging_tpu_torch.cov.matern import MultivariateMatern
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate import bootstrap as TB
from cokriging_tpu_torch.estimate.empirical import (
    EmpiricalVariogram, VarioConfig, empirical_variogram_pair,
)
from cokriging_tpu_torch.estimate.vecchia import VecchiaLikelihood, fit_vecchia
from cokriging_tpu_torch.estimate.wls import fit_wls_batch, fit_wls_batch_arrays
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor
from cokriging_tpu_torch.predict.local import LocalPredictor

torch.set_num_threads(1)

SIM_FLAT = [1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.0, 0.0, -0.6]
WLS_BOUNDS = dict(sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0), nugget_bounds=(0.0, 0.5))


def cpu_mesh(n=8):
    return P.make_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's cofield: 17 x 17 grid, 2 x 50 samples with
    noise 0.1, in both packages' containers."""
    jmod = JMod(params=JParams.from_flat(np.array(SIM_FLAT)))
    rf = JField(jmod, JGrid(xcount=17, ycount=17), seed=5)
    samples = rf.sample(size=50, epsilon=[0.1, 0.1], seed=6)
    tmf = MultiField(fields=[Field.from_arrays(s[["x", "y"]].values, s[f"Z{k}"].values, f"Z{k}")
                             for k, s in enumerate(samples)])
    tmod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(SIM_FLAT, dtype=torch.float64)))
    return jmod, rf.to_fields(samples), tmod, tmf, rf.grid.coords.values


def test_make_mesh_raises_without_cards_and_builds_virtual_shards():
    for n in (None, 1, 2):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            P.make_mesh(n)
    mesh = cpu_mesh()
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")}
    assert mesh.axis_names == ("data",) and P.make_mesh(device="cpu").size == 1


def test_shard_batch_rows_halve_as_the_mesh_doubles():
    """Counterpart of tests/test_parallel.py:146-168: the per-shard rows of
    ``shard_batch`` halve as the mesh doubles, and the shards are the rows
    in order; ``replicate`` gives every shard the whole tree."""
    arr = torch.arange(64.0 * 3).reshape(64, 3)
    prev = None
    for n in (1, 2, 4, 8):
        shards = P.shard_batch(cpu_mesh(n), arr)
        assert len(shards) == n and all(s.shape == (64 // n, 3) for s in shards)
        assert torch.equal(torch.cat(shards), arr)
        if prev is not None:
            assert shards[0].shape[0] == prev // 2
        prev = shards[0].shape[0]
    with pytest.raises(ValueError, match="split"):
        P.shard_batch(cpu_mesh(8), arr[:63])
    reps = P.replicate(cpu_mesh(3), {"a": arr, "b": (arr[0], np.ones(2))})
    assert len(reps) == 3 and all(torch.equal(r["b"][1], torch.ones(2, dtype=torch.float64))
                                  for r in reps)


@pytest.mark.parametrize("marginal", [False, True])
def test_sharded_variogram_pair_matches_jax(marginal):
    """tests/test_parallel.py:124-143: 700 x 650 CONUS points, 12 bins to
    2000 km; counts equal to the JAX package's sharded pass, centers within
    1e-12 and means rtol 1e-9 of it; centers and counts equal to the port's
    unsharded pass, means rtol 1e-12."""
    rng = np.random.default_rng(42)
    n, m = 700, 650
    ca = np.column_stack([rng.uniform(25, 50, n), rng.uniform(-120, -70, n)])
    cb = np.column_stack([rng.uniform(25, 50, m), rng.uniform(-120, -70, m)])
    va, vb = rng.normal(size=n), rng.normal(size=m)
    b, w = (ca, va) if marginal else (cb, vb)
    jc, jm, jn = JP.sharded_variogram_pair(ca, va, b, w, JConfig(max_dist=2000.0, n_bins=12),
                                           marginal=marginal, mesh=JP.make_mesh())
    cfg = VarioConfig(max_dist=2000.0, n_bins=12)
    c, mean, cnt = P.sharded_variogram_pair(ca, va, b, w, cfg, marginal, mesh=cpu_mesh())
    # the two packages form h in another operation order, which moves the
    # bin centers by ulps (a few 1e-13 of 2000 km)
    np.testing.assert_allclose(c, jc, rtol=1e-12)
    np.testing.assert_array_equal(cnt, jn)
    np.testing.assert_allclose(mean, jm, rtol=1e-9)
    c1, m1, n1 = empirical_variogram_pair(ca, va, b, w, cfg, marginal, device="cpu")
    np.testing.assert_array_equal(c, c1)
    np.testing.assert_array_equal(cnt, n1)
    np.testing.assert_allclose(mean, m1, rtol=1e-12)


def test_sharded_local_predict_matches_jax(setup):
    """tests/test_parallel.py:35-54: prediction at every 4th grid cell (73,
    not divisible by 8) and LOOCV at the 50 data of process 0 against the
    JAX package's sharded calls, rtol 1e-10, and equal to the port's
    unsharded calls. The errors also get atol 1e-7: at a site that holds a
    datum of each process (nugget 0) the kriging variance is round-off, and
    its clamped square root ~1e-8 in either package."""
    jmod, jmf, tmod, tmf, grid = setup
    jl, tl = JLocal(jmod, jmf), LocalPredictor(tmod, tmf, device="cpu")
    for cv, pc in ((False, grid[::4]), (True, np.asarray(jmf.fields[0].coords_main))):
        want = JP.sharded_local_predict(jl, 0, pc, max_dist=0.6, cv=cv)
        got = P.sharded_local_predict(tl, 0, pc, max_dist=0.6, mesh=cpu_mesh(), cv=cv)
        one = (tl.cross_validation(0, max_dist=0.6, postprocess=False) if cv
               else tl(0, pc, max_dist=0.6, postprocess=False))
        for g, w, o, atol in zip(got, want, (one.pred, one.pred_err), (0.0, 1e-7)):
            assert g.shape == (pc.shape[0],)
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=atol)
            np.testing.assert_array_equal(g, o)


def test_sharded_direct_local_predict_matches_unsharded(setup):
    """``materialize_cov=False``: each shard assembles its local systems
    from gathered coordinates with the replicated parameter table; equal
    to the unsharded direct path (rtol 1e-10)."""
    _, _, tmod, tmf, grid = setup
    lp = LocalPredictor(tmod, tmf, device="cpu", materialize_cov=False, neighbor_method="device")
    pc = grid[::9]
    want = lp(1, pc, max_dist=0.6, postprocess=False)
    pred, err = P.sharded_local_predict(lp, 1, pc, max_dist=0.6, mesh=cpu_mesh(3))
    np.testing.assert_allclose(pred, want.pred, rtol=1e-10)
    np.testing.assert_allclose(err, want.pred_err, rtol=1e-10)


VFLAT = [1.1, 0.9, 1.5, 1.2, 1.4, 0.25, 0.3, 0.27, 0.04, 0.06, -0.55]


def test_sharded_vecchia_nll_matches_jax():
    """tests/test_vecchia_sharded.py's likelihood at 40 + 43 points (83
    terms, m = 12, chunk 16: shards of 16 terms, the last one short): the
    value rtol 1e-10 and the gradient rtol 1e-7 / atol 1e-10 against the
    JAX package's sharded NLL, and the value against the port's unsharded
    one to 1e-12."""
    rng = np.random.default_rng(5)
    coords = [rng.uniform(0, 1, (40, 2)), rng.uniform(0, 1, (43, 2))]
    values = [rng.normal(size=40), rng.normal(size=43)]
    spec = JParams.default(2).spec
    jlik = JVecchia(coords, values, m=12, geodesic=False, chunk=16)
    mesh = JP.make_mesh()
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda f: JP.sharded_vecchia_nll(jlik, f, spec, mesh=mesh, chunk=16)))(jnp.asarray(VFLAT))
    lik = VecchiaLikelihood(coords, values, m=12, geodesic=False, chunk=16, device="cpu")
    tspec = MaternParams.default(2).spec
    flat = torch.tensor(VFLAT, dtype=torch.float64, requires_grad=True)
    got = P.sharded_vecchia_nll(lik, flat, tspec, mesh=cpu_mesh(), chunk=16)
    (grad,) = torch.autograd.grad(got, flat)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(got.detach()), float(lik.nll(torch.tensor(VFLAT, dtype=torch.float64), tspec)),
                               rtol=1e-12)


def test_fit_vecchia_mesh_matches_unsharded():
    """A Vecchia fit (2 x 40 points at distinct sites, m = 8, chunk 32,
    8 iterations) with the objective sharded over eight shards (terms in
    ranges of 32: three full shards and a short one): the unsharded fit's
    parameters (rtol 1e-8) and NLL. The sites differ between the processes
    and the nugget has a floor, so no window is singular; on
    tests/test_vecchia_sharded.py's co-located sites, penalty plateaus make
    the trajectory chaotic in the last ulp of the objective."""
    rng = np.random.default_rng(9)
    coords = [rng.uniform(0, 1, (40, 2)) for _ in range(2)]
    vals = rng.normal(size=40)
    mf = MultiField(fields=[Field.from_arrays(coords[k], vals + 0.3 * rng.normal(size=40), f"Z{k}")
                            for k in range(2)])
    spec = ParamSpec(n_procs=2, len_scale_bounds=(0.05, 2.0), sigma_bounds=(0.2, 3.0),
                     nugget_bounds=(0.01, 0.5), rho_bounds=(-0.9, 0.9))
    init = MaternParams.from_flat(
        torch.tensor([1.0, 1.0, 1.4, 1.3, 1.2, 0.5, 0.5, 0.5, 0.05, 0.05, 0.0],
                     dtype=torch.float64), spec=spec)
    kw = dict(m=8, maxiter=8, main=False, chunk=32, init=init, device="cpu")
    p_one, i_one = fit_vecchia(mf, **kw)
    p_mesh, i_mesh = fit_vecchia(mf, mesh=cpu_mesh(), **kw)
    np.testing.assert_allclose(p_mesh.to_flat().numpy(), p_one.to_flat().numpy(), rtol=1e-8)
    np.testing.assert_allclose(i_mesh["nll"], i_one["nll"], rtol=1e-10)


@pytest.fixture(scope="module")
def wls_batch(setup):
    """tests/test_parallel.py:57-109's batch: the cofield's variograms (1.0,
    8 bins, Euclidean) from the JAX package, 11 members (not divisible by 8)
    started near the truth."""
    _, jmf, _, _, _ = setup
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = j_variograms(jmf, JConfig(1.0, 8, geodesic=False))
    rng = np.random.default_rng(0)
    spec = ParamSpec(2, **WLS_BOUNDS)
    lo, hi = spec.bounds()
    flats = np.clip(np.tile([1.0, 1.0, 1.5, 1.5, 1.5, 0.1, 0.1, 0.1, 0.01, 0.01, 0.0], (11, 1))
                    + rng.normal(scale=0.02, size=(11, 11)), lo, hi)
    centers = np.tile(est.bin_centers[None], (11, 1, 1))
    means = np.nan_to_num(np.tile(est.bin_means[None], (11, 1, 1)), nan=1.0)
    counts = np.tile(est.bin_counts[None], (11, 1, 1))
    return est, spec, flats, centers, means, counts


def test_sharded_wls_grad_step_matches_jax(wls_batch):
    est, spec, flats, centers, means, counts = wls_batch
    want = JP.sharded_wls_grad_step(flats, centers, means, counts, est.pairs,
                                    JSpec(2, **WLS_BOUNDS), lr=1e-5, mesh=JP.make_mesh())
    got = P.sharded_wls_grad_step(flats, centers, means, counts, est.pairs, spec, lr=1e-5,
                                  mesh=cpu_mesh())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-10)


def test_fit_wls_batch_mesh_is_bit_equal(wls_batch):
    """The members split 4 / 4 / 3 over three shards, stepped in lockstep:
    every result bit for bit the unsharded batch's (a member's fit is its
    fit alone), through ``fit_wls_batch_arrays`` and ``fit_wls_batch``."""
    est, spec, flats, centers, means, counts = wls_batch
    args = (flats, centers, means, counts, est.pairs, spec)
    one = fit_wls_batch_arrays(*args, maxiter=8, device="cpu")
    sharded = fit_wls_batch_arrays(*args, maxiter=8, mesh=cpu_mesh(3))
    for a, b in zip(sharded, one):
        assert a.shape == b.shape and np.array_equal(a, b)
    ests = [EmpiricalVariogram(VarioConfig(1.0, 8, geodesic=False), list(est.pairs),
                               est.bin_centers, est.bin_means * s, est.bin_counts)
            for s in (0.9, 1.0, 1.1)]
    init = MaternParams.from_flat(torch.as_tensor(flats[0]), spec=spec)
    p_one, c_one, _ = fit_wls_batch(ests, init=init, maxiter=8, device="cpu")
    p_mesh, c_mesh, _ = fit_wls_batch(ests, init=init, maxiter=8, mesh=cpu_mesh(2),
                                      device="cpu")
    assert np.array_equal(c_mesh, c_one)
    for a, b in zip(p_mesh, p_one):
        assert torch.equal(a.to_flat(), b.to_flat())


def test_bootstrap_mesh_is_bit_equal(setup):
    """tests/test_bootstrap.py:102-109's call, smaller (4 replicates,
    maxiter 20, seed 3), with the refit sharded over two virtual shards:
    the replicates' fits bit for bit the unsharded bootstrap's."""
    _, _, tmod, tmf, _ = setup
    mod = MultivariateMatern(params=MaternParams.from_flat(
        torch.tensor(SIM_FLAT, dtype=torch.float64), spec=ParamSpec(2, **WLS_BOUNDS)))
    cfg = VarioConfig(max_dist=0.9, n_bins=10, geodesic=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = TB.parametric_bootstrap(mod, tmf, cfg, n_rep=4, seed=3, maxiter=20, device="cpu")
        sharded = TB.parametric_bootstrap(mod, tmf, cfg, n_rep=4, seed=3, maxiter=20,
                                          mesh=cpu_mesh(2), device="cpu")
    assert np.array_equal(sharded.flats, one.flats)
    assert np.array_equal(sharded.costs, one.costs)


def test_iterative_mesh_matches_unsharded():
    """A smaller system than tests/test_iterative.py:105's (2 x 15 / 18
    points, 13 locations: the port's CPU K_nu costs ~15 ms per row tile) at
    its bars (tol 1e-10, rtol 1e-8 / atol 1e-10): the 33 rows padded to 36
    over two shards of one 18-row tile each, against the unsharded CG in
    one 36-row tile; prediction with errors and LOOCV."""
    rng = np.random.default_rng(0)
    coords = [rng.uniform(0.0, 1.0, (15, 2)), rng.uniform(0.0, 1.0, (18, 2))]
    values = [rng.normal(size=15), rng.normal(size=18)]
    pc = np.random.default_rng(3).uniform(0.1, 0.9, (13, 2))
    mf = MultiField(fields=[Field.from_arrays(c, v, f"Z{k}")
                            for k, (c, v) in enumerate(zip(coords, values))])
    flat = [1.0, 1.3, 1.5, 1.2, 0.8, 0.25, 0.2, 0.3, 0.05, 0.08, -0.5]
    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(flat, dtype=torch.float64)))
    kw = dict(rhs_batch=16, tol=1e-10, maxiter=500, device="cpu")
    one = IterativeJointPredictor(mod, mf, block=36, **kw)
    sharded = IterativeJointPredictor(mod, mf, block=18, mesh=cpu_mesh(2), **kw)
    for call in (lambda p: p(0, pc, postprocess=False),
                 lambda p: p.cross_validation(1, postprocess=False)):
        want, got = call(one), call(sharded)
        np.testing.assert_allclose(got.pred, want.pred, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(got.pred_err, want.pred_err, rtol=1e-8, atol=1e-10)
        np.testing.assert_array_equal(got.n_neighbors, want.n_neighbors)
