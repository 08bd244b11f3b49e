"""The port's Vecchia likelihood (orderings, neighbors, windows, value and
gradient, fitters) against the JAX package's ``estimate/vecchia.py`` and
the port's own exact NLL, on the CPU in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov.params import MaternParams as JParams
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate import vecchia as JV
from cokriging_tpu.fields.field import Field as JField
from cokriging_tpu.fields.field import MultiField as JMultiField
from cokriging_tpu_torch.cov.matern import windows_covariance
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate import vecchia as TV
from cokriging_tpu_torch.estimate.nll import joint_distance_blocks, neg_log_likelihood
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.kernels.distance import euclidean_matrix
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

FLAT = np.array([1.1, 0.9, 1.5, 1.2, 1.4, 0.25, 0.3, 0.27, 0.04, 0.06, -0.55])
SPEC = ParamSpec(n_procs=2)
# a box of valid models around the data's truth (the reference's fit tests)
FIT_SPEC = dict(n_procs=2, len_scale_bounds=(0.05, 2.0), sigma_bounds=(0.2, 3.0))
FIT_INIT = [1.0, 1.0, 1.5, 1.5, 1.5, 0.5, 0.5, 0.5, 0.05, 0.05, 0.0]


def _data(n=90, seed=3):
    """A bivariate field drawn from the truth FLAT on an irregular sample
    of the unit square, half of the second process colocated with the
    first (the reference test's data, made with numpy)."""
    rng = np.random.default_rng(seed)
    c1 = rng.uniform(0, 1, (n, 2))
    c2 = np.concatenate([c1[: n // 2], rng.uniform(0, 1, (n - n // 2, 2))])
    dists = joint_distance_blocks([torch.as_tensor(c1), torch.as_tensor(c2)], geodesic=False)
    from cokriging_tpu_torch.cov.matern import block_covariance

    with torch.no_grad():
        C = block_covariance(params_from_numpy(FLAT), dists).numpy()
    z = np.linalg.cholesky(C + 1e-10 * np.eye(len(C))) @ rng.normal(size=len(C))
    return [c1, c2], [z[:n], z[n:]]


@pytest.fixture(scope="module")
def data():
    return _data()


def _windows_both(coords, values, m, mvar=None, chunk=64):
    """One set of windows, from numpy, in both packages: the port's maxmin
    order and device neighbors (held against the reference below)."""
    c = np.concatenate(coords)
    z = np.concatenate(values)
    procs = np.concatenate([np.full(len(a), k) for k, a in enumerate(coords)])
    perm = TV.maxmin_order(c, geodesic=False, device="cpu")
    c, z, procs = c[perm], z[perm], procs[perm]
    mv = None if mvar is None else mvar[perm]
    nbr, mask = TV.nearest_previous_neighbors(c, m, geodesic=False, device="cpu")
    t_win = TV._term_windows(c, z, procs, mv, nbr, mask, "cpu")
    j_win = JV._term_windows(c, z, procs.astype(np.int32), mv, nbr, mask)
    return t_win, j_win


def test_maxmin_order_matches_jax():
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 1, (200, 2))
    np.testing.assert_array_equal(TV.maxmin_order(coords, geodesic=False, device="cpu"),
                                  JV.maxmin_order(coords, geodesic=False))
    geo = np.column_stack([rng.uniform(25, 50, 150), rng.uniform(-120, -70, 150)])
    np.testing.assert_array_equal(TV.maxmin_order(geo, geodesic=True, device="cpu"),
                                  JV.maxmin_order(geo, geodesic=True))


@pytest.mark.parametrize("geodesic", [False, True])
def test_coarse_to_fine_order_matches_jax(geodesic):
    rng = np.random.default_rng(0)
    if geodesic:
        c = np.column_stack([rng.uniform(25, 50, 300), rng.uniform(-120, -70, 300)])
    else:
        c = rng.uniform(0, 1, (500, 2))
    c[10] = c[200]  # an exact duplicate
    perm = TV.coarse_to_fine_order(c, geodesic=geodesic)
    assert sorted(perm.tolist()) == list(range(len(c)))
    np.testing.assert_array_equal(perm, JV.coarse_to_fine_order(c, geodesic=geodesic))


@pytest.mark.parametrize("geodesic", [False, True])
def test_device_neighbors_match_jax_sets(geodesic):
    """Same masks and, row by row, the same neighbor sets (the order of
    equal distances is free)."""
    rng = np.random.default_rng(1)
    c = rng.uniform(0, 1, (60, 2)) if not geodesic else np.column_stack(
        [rng.uniform(25, 50, 60), rng.uniform(-120, -70, 60)])
    nbr, mask = TV.nearest_previous_neighbors(c, 5, geodesic=geodesic, block=16, device="cpu")
    j_nbr, j_mask = JV.nearest_previous_neighbors(c, 5, geodesic=geodesic, block=16)
    np.testing.assert_array_equal(mask, j_mask)
    assert not mask[0].any()
    for i in range(60):
        assert set(nbr[i][mask[i]].tolist()) == set(j_nbr[i][j_mask[i]].tolist()), i


def test_kd_neighbors_match_jax():
    """The host kd search (doubling blocks past a 64-row exact prefix,
    geodesic, a colocated pair late in the ordering) equals the reference's
    array for array."""
    rng = np.random.default_rng(2)
    c = np.column_stack([rng.uniform(25, 50, 400), rng.uniform(-120, -70, 400)])
    c[390] = c[391]
    c_ord = c[TV.coarse_to_fine_order(c, geodesic=True)]
    got = TV.nearest_previous_neighbors_kd(c_ord, 8, geodesic=True, exact_prefix=64)
    want = JV.nearest_previous_neighbors_kd(c_ord, 8, geodesic=True, exact_prefix=64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_full_conditioning_equals_exact_nll():
    """m = N - 1: the Vecchia product is the exact likelihood for any
    ordering; the port's Vecchia NLL equals the port's exact NLL."""
    coords, values = _data(n=30, seed=4)
    n = 60
    lik = TV.VecchiaLikelihood(coords, values, m=n - 1, geodesic=False, chunk=25, device="cpu")
    x = torch.as_tensor(FLAT)
    with torch.no_grad():
        got = float(lik.nll(x, SPEC))
        dists = joint_distance_blocks([torch.as_tensor(c) for c in coords], geodesic=False)
        want = float(neg_log_likelihood(x, dists, torch.as_tensor(np.concatenate(values)), SPEC))
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("with_mvar", [False, True])
def test_value_and_gradient_match_jax(data, with_mvar):
    """Value rtol 1e-10 and gradient rtol 1e-8 against the reference's
    jitted value_and_grad on the same windows, in chunks of 64 terms with a
    ragged tail."""
    coords, values = data
    mvar = np.random.default_rng(5).uniform(0, 0.02, 180) if with_mvar else None
    t_win, j_win = _windows_both(coords, values, m=10, mvar=mvar)
    v, g = TV.vecchia_nll_value_and_grad(torch.as_tensor(FLAT), t_win, SPEC, False, 64)
    jv, jg = JV.vecchia_nll_value_and_grad(jnp.asarray(FLAT), j_win, JSpec(n_procs=2), False, 64)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-10)


def test_non_pd_point_penalty_and_zero_gradient(data):
    """|rho| ~ 1 with colocated cross-process samples: the windows that do
    not factorize give 2e6 each with an exactly zero gradient, the total is
    finite and equals the reference's, value and gradient."""
    coords, values = data
    t_win, j_win = _windows_both(coords, values, m=15)
    bad_flat = np.array([1.1, 0.9, 1.5, 1.5, 1.4, 0.25, 0.25, 0.27, 0.0, 0.0, 0.9999])
    v, g = TV.vecchia_nll_value_and_grad(torch.as_tensor(bad_flat), t_win, SPEC, False, 64)
    jv, jg = JV.vecchia_nll_value_and_grad(jnp.asarray(bad_flat), j_win, JSpec(n_procs=2),
                                           False, 64)
    assert np.isfinite(float(v)) and float(v) > 1e5
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-8)
    # the windows that do not factorize, alone: penalty per window, exactly
    # zero gradient
    coords, _, procs, mvar, mask = t_win
    with torch.no_grad():
        cov = windows_covariance(params_from_numpy(bad_flat), euclidean_matrix(coords, coords),
                                 procs, mvar)
        m2 = mask[:, :, None] & mask[:, None, :]
        cov = torch.where(m2, cov, torch.eye(cov.shape[-1], dtype=cov.dtype))
        sel = torch.nonzero(torch.linalg.cholesky_ex(cov)[1] != 0)[:, 0]
    assert 0 < len(sel) < len(cov)
    x = torch.as_tensor(bad_flat).requires_grad_(True)
    v_bad = TV._chunk_nll(x, SPEC, tuple(a[sel] for a in t_win), False)
    (g_bad,) = torch.autograd.grad(v_bad, x)
    assert v_bad.item() == TV._BAD_TERM * len(sel)
    assert not bool(g_bad.any())


def test_kd_scaffold_matches_jax(data):
    """The coarse ordering and the kd neighbors, forced at a small exact
    prefix (the regime of 10^5+ points), build the same likelihood as the
    reference's scaffold."""
    coords, values = data
    kw = dict(m=12, geodesic=False, chunk=64, ordering="coarse", neighbor_method="kd",
              kd_exact_prefix=32)
    lik = TV.VecchiaLikelihood(coords, values, device="cpu", **kw)
    jlik = JV.VecchiaLikelihood(coords, values, **kw)
    np.testing.assert_array_equal(lik.perm, jlik.perm)
    for a, b in zip(lik._win, jlik._win):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with torch.no_grad():
        got = float(lik.nll(torch.as_tensor(FLAT), SPEC))
    np.testing.assert_allclose(got, float(jlik.nll(jnp.asarray(FLAT), JSpec(n_procs=2))),
                               rtol=1e-10)


def _fields(coords, values, cls_f, cls_mf, dtype=np.float64):
    fields = []
    for k in range(2):
        f = cls_f.from_arrays(np.asarray(coords[k], dtype), np.asarray(values[k], dtype), f"Z{k}")
        f.geodesic = False
        fields.append(f)
    return cls_mf(fields=fields)


@pytest.fixture(scope="module")
def jax_fit(data):
    coords, values = data
    spec = JSpec(**FIT_SPEC)
    init = JParams.default(2, spec).with_flat(jnp.asarray(FIT_INIT))
    return JV.fit_vecchia(_fields(coords, values, JField, JMultiField), init=init, m=6,
                          maxiter=30, main=False, chunk=64)


def _port_init():
    spec = ParamSpec(**FIT_SPEC)
    return MaternParams.default(2, spec).with_flat(torch.tensor(FIT_INIT, dtype=torch.float64))


def test_fit_vecchia_matches_jax(data, jax_fit):
    """The host scipy fit lands where the reference's lands: its Vecchia NLL
    within max(0.5, 5e-3 |nll|) and the identifiable cross-correlation
    within 0.1 (the reference's own device-vs-host bars)."""
    coords, values = data
    p, info = TV.fit_vecchia(_fields(coords, values, Field, MultiField), init=_port_init(),
                             m=6, maxiter=30, main=False, chunk=64, device="cpu")
    jp, jinfo = jax_fit
    assert abs(info["nll"] - jinfo["nll"]) <= max(0.5, 5e-3 * abs(jinfo["nll"]))
    np.testing.assert_allclose(float(p.rho[0, 1]), float(jp.rho[0, 1]), atol=0.1)
    assert float(p.rho[0, 1]) < -0.2
    assert info["n_obj_evals"] == len(info["nll_trace"]) and info["m"] == 6 and info["n"] == 180
    with pytest.raises(TypeError, match="parallel.Mesh"):
        TV.fit_vecchia(_fields(coords, values, Field, MultiField), mesh=object(), device="cpu")


def test_fit_vecchia_device_matches_host(data, jax_fit):
    """The on-device L-BFGS fitter reaches the reference host fit's optimum
    (NLL within max(0.5, 5e-3 |nll|), rho within 0.1) and reports a real
    iteration count."""
    coords, values = data
    p, info = TV.fit_vecchia_device(_fields(coords, values, Field, MultiField),
                                    init=_port_init(), m=6, maxiter=40, main=False, chunk=64,
                                    device="cpu")
    jp, jinfo = jax_fit
    assert info["nll"] <= jinfo["nll"] + max(0.5, 5e-3 * abs(jinfo["nll"]))
    np.testing.assert_allclose(float(p.rho[0, 1]), float(jp.rho[0, 1]), atol=0.1)
    assert 0 < info["n_iter"] <= 40 + 1  # evaluations, the first one included


def test_fit_vecchia_float32_fields_stay_float32(data):
    """float32 fields: scipy's float64 iterate is cast to the windows' dtype
    and the parameters come back in it."""
    coords, values = data
    p, info = TV.fit_vecchia(_fields(coords, values, Field, MultiField, np.float32),
                             init=_port_init(), m=6, maxiter=3, main=False, chunk=64,
                             device="cpu")
    assert np.isfinite(info["nll"]) and p.sigma.dtype == torch.float32
