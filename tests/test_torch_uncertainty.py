"""Parameter uncertainty in the port (``estimate/uncertainty.py``) against the
JAX package's, on the CPU in float64, and the block covariance's second
order behind it (``cov.matern._ScaledMaternBlockGrad`` and the plain
versions of its two kernels).

The JAX reference is the JAX package's ``observed_information`` computation
(``jax.hessian`` of its ``neg_log_likelihood(..., analytic_grad=False)``,
symmetrized), jitted once for 2 x 25 points (``_jax_information``; the NLL
reads only the parameter values, not the spec's bounds, so one compiled
program serves every case of that size) and evaluated at two parameter
points, nu = 1.4 / 1.3 / 1.2, off the half-integers, and the truth of
``examples/uncertainty_demo.py`` (nu = 1.5, where the reference's CF2
tangent is truncated and the port follows it), and at the parameters of the
CLI's ``fit --std-errors``. Bars: 1e-8 of max|H| against JAX (measured
~2e-14); the block Function's Hessian against the elementwise one 1e-12 of
max|H| (measured ~3e-16).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate import nll_std_errors as j_std_errors
from cokriging_tpu.estimate.nll import joint_distance_blocks as j_blocks
from cokriging_tpu.estimate.nll import neg_log_likelihood as j_nll
from cokriging_tpu_torch.cov.matern import block_covariance, matern_correlation
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate import nll_std_errors, observed_information
from cokriging_tpu_torch.estimate.nll import joint_distance_blocks
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.kernels import cuda_ops as K

torch.set_num_threads(1)

SPEC_KW = dict(n_procs=2, sigma_bounds=(0.1, 3.0), len_scale_bounds=(0.02, 1.0),
               nugget_bounds=(0.0, 0.5))
# examples/uncertainty_demo.py's truth (nu = 1.5), and a point off the
# half-integers
TRUTH = np.array([1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.05, 0.05, -0.6])
OFF_HALF = np.array([1.1, 0.9, 1.4, 1.3, 1.2, 0.25, 0.2, 0.3, 0.06, 0.04, -0.5])
POINTS = {"nu_off_half": OFF_HALF, "truth_nu_1.5": TRUTH}
N = 25


def _data(n=N, seed=5):
    rng = np.random.default_rng(seed)
    coords = [rng.uniform(0.0, 1.0, (n, 2)) for _ in range(2)]
    coords[1][:4] = coords[0][:4]  # colocated pairs: the cross block has exact zeros
    return coords, [rng.normal(size=n) for _ in range(2)]


def _params(flat):
    return MaternParams.from_flat(torch.tensor(flat), spec=ParamSpec(**SPEC_KW))


@jax.jit
def _jax_information(flat, d00, d01, d11, z):
    """The JAX package's observed information (its ``observed_information``:
    ``jax.hessian`` of the plain-AD NLL, symmetrized) of two processes."""
    h = jax.hessian(lambda f: j_nll(f, [[d00, d01], [d01.T, d11]], z, JSpec(**SPEC_KW), None,
                                    0.0, analytic_grad=False))(flat)
    return 0.5 * (h + h.T)


def _jax_info_of(flat, dists, z):
    return np.asarray(_jax_information(jnp.asarray(flat), dists[0][0], dists[0][1], dists[1][1],
                                       z), np.float64)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's observed information at both points."""
    coords, values = _data()
    dists = j_blocks([jnp.asarray(c) for c in coords], geodesic=False)
    z = jnp.concatenate([jnp.asarray(v) for v in values])
    out = {name: _jax_info_of(flat, dists, z) for name, flat in POINTS.items()}
    mf = MultiField([Field.from_arrays(c, v, name=f"z{k}")
                     for k, (c, v) in enumerate(zip(coords, values))])
    return mf, out


@pytest.mark.parametrize("point", sorted(POINTS))
def test_observed_information_matches_jax(reference, point):
    mf, ref = reference
    info = observed_information(_params(POINTS[point]), mf, device="cpu")
    assert info.shape == (11, 11) and info.dtype == np.float64
    np.testing.assert_array_equal(info, info.T)
    assert np.abs(info - ref[point]).max() <= 1e-8 * np.abs(ref[point]).max()


def _block_nll(flat, dists, z, h_grad):
    p = MaternParams.from_flat(flat, spec=ParamSpec(**SPEC_KW))
    chol = torch.linalg.cholesky(block_covariance(p, dists, h_grad=h_grad))
    alpha = torch.linalg.solve_triangular(chol, z[:, None], upper=False)[:, 0]
    return 0.5 * (alpha @ alpha) + torch.log(chol.diagonal()).sum()


def test_block_function_hessian_equals_the_elementwise_one():
    """A Hessian through the block Function (``h_grad=False``: the plain
    versions of the block-gradient, tangent and Hessian-sum kernels) against
    the one through the elementwise model and K_nu's double backward
    (``h_grad=True``), with a symmetric cotangent's lower-triangle reading
    and the cross block's exact zeros; and the Hessian-sum launch serves
    every row."""
    coords, values = _data(n=10, seed=8)
    dists = joint_distance_blocks([torch.tensor(c) for c in coords], geodesic=False)
    z = torch.tensor(np.concatenate(values))
    x = torch.tensor(OFF_HALF, dtype=torch.float64)
    h_elem = torch.autograd.functional.hessian(lambda f: _block_nll(f, dists, z, True), x)
    h_block = torch.autograd.functional.hessian(lambda f: _block_nll(f, dists, z, False), x)
    assert float((h_block - h_elem).abs().max()) <= 1e-12 * float(h_elem.abs().max())


def test_plain_second_order_versions_match_autograd_of_the_block():
    """The plain tangent is the block's directional derivative (a JVP of the
    elementwise block in (scale, nugget, nu, ls)); the plain Hessian sums
    are the second derivatives in (nu, ls) of sum ct * M taken on the
    scalar parameters (not per entry), and their first two the block
    gradient's last two over the scale. 1e-12 relative."""
    rng = np.random.default_rng(9)
    c = torch.tensor(rng.uniform(0.0, 1.0, (12, 2)))
    c[3] = c[1]
    h = torch.cdist(c, c)
    ct = torch.tensor(rng.normal(size=(12, 12)))
    theta = torch.tensor([1.7, 0.05, 1.37, 0.3], dtype=torch.float64)
    w = torch.tensor([0.7, -1.3, 0.4, 2.1e-3], dtype=torch.float64)

    def block(t):
        return t[0] * matern_correlation(t[2], t[3], h) + t[1] * (h == 0.0)

    _, jvp = torch.autograd.functional.jvp(block, theta, w)
    tangent = K.matern_block_tangent_plain(
        theta[0], w, K.matern_block_partials_plain(theta[2], theta[3], h, symmetric=True))
    assert float((tangent - jvp).abs().max()) <= 1e-12 * float(jvp.abs().max())

    def sums(t):
        return (ct * matern_correlation(t[0], t[1], h)).sum()

    hess = torch.autograd.functional.hessian(sums, theta[2:])
    for sym in (False, True):
        got = K.matern_block_hess_plain(theta[2], theta[3], h, ct, symmetric=sym)
        want = torch.stack([hess[0, 0], hess[0, 1], hess[1, 1]])
        assert float((got[2:] - want).abs().max()) <= 1e-12 * float(want.abs().max())
        g = K.matern_block_grad_plain(theta[0], theta[1], theta[2], theta[3], h, ct, sym)
        np.testing.assert_allclose(got[:2].numpy(), (g[2:] / theta[0]).numpy(), rtol=1e-12)


def test_plain_partials_match_autograd_of_the_block():
    """``matern_block_partials_plain``: the M field is the elementwise
    model where h > 0 and the code -1 at h == 0 (colocated points), and the
    two partial fields are the JVPs of the model along nu and along ls,
    within 1e-12 of each field's largest |entry|."""
    rng = np.random.default_rng(9)
    c = torch.tensor(rng.uniform(0.0, 1.0, (12, 2)))
    c[3] = c[1]
    h = torch.cdist(c, c)
    nu, ls = torch.tensor(1.37, dtype=torch.float64), torch.tensor(0.3, dtype=torch.float64)
    got = K.matern_block_partials_plain(nu, ls, h, symmetric=True)
    assert got.shape == (3, 12, 12) and got.dtype == torch.float64
    pos = h > 0.0
    np.testing.assert_array_equal(got[0][~pos].numpy(), -1.0)
    want = [matern_correlation(nu, ls, h)]
    for t in ((1.0, 0.0), (0.0, 1.0)):
        _, d = torch.autograd.functional.jvp(lambda a, b: matern_correlation(a, b, h), (nu, ls),
                                             tuple(torch.tensor(v, dtype=torch.float64)
                                                   for v in t))
        want.append(torch.where(pos, d, 0.0))
    for k, w in enumerate(want):
        assert float((got[k][pos] - w[pos]).abs().max()) <= 1e-12 * float(w.abs().max()), k
    assert bool((got[1:, ~pos] == 0).all())


def test_block_hessian_builds_partials_once_and_combines_per_row(monkeypatch):
    """A CPU Hessian through the block Function builds each block's tangent
    partials once (3 builds for its 3 blocks) and runs one combine per row
    and block (33), and equals bit for bit the Hessian whose every row
    recomputes the plain tangent from h."""
    coords, values = _data(n=10, seed=8)
    dists = joint_distance_blocks([torch.tensor(c) for c in coords], geodesic=False)
    z = torch.tensor(np.concatenate(values))
    x = torch.tensor(OFF_HALF, dtype=torch.float64)
    partials, tangent = K.matern_block_partials, K.matern_block_tangent
    calls = {"partials": 0, "tangent": 0}
    built = {}  # the arguments of each build, by the buffer it returned

    def count_partials(*a, **kw):
        calls["partials"] += 1
        out = partials(*a, **kw)
        built[id(out)] = (a, kw)
        return out

    def count_tangent(scale, w, parts):
        calls["tangent"] += 1
        assert id(parts) in built
        return tangent(scale, w, parts)

    monkeypatch.setattr(K, "matern_block_partials", count_partials)
    monkeypatch.setattr(K, "matern_block_tangent", count_tangent)
    hess = torch.autograd.functional.hessian(lambda f: _block_nll(f, dists, z, False), x)
    assert calls == {"partials": 3, "tangent": 33}

    def per_row(scale, w, parts):  # the tangent rebuilt from h at every row
        a, kw = built[id(parts)]
        return tangent(scale, w, partials(*a, **kw))

    monkeypatch.setattr(K, "matern_block_tangent", per_row)
    again = torch.autograd.functional.hessian(lambda f: _block_nll(f, dists, z, False), x)
    assert torch.isfinite(hess).all()
    assert torch.equal(hess.view(torch.int64), again.view(torch.int64))


def _frames_equal(t, j):
    assert list(t.columns) == list(j.columns)
    assert list(t["name"]) == list(j["name"]) and list(t["bounds"]) == list(j["bounds"])
    np.testing.assert_allclose(t["value"], j["value"], rtol=1e-15)
    np.testing.assert_allclose(t["std_err"], j["std_err"], rtol=1e-12)
    assert list(t["at_bound"]) == list(j["at_bound"])
    for key in ("covariance", "correlation"):
        np.testing.assert_allclose(t.attrs[key], j.attrs[key], rtol=1e-12)


def test_std_errors_frame_bounds_and_pinv_warning_match_jax(reference):
    """``nll_std_errors`` on a given information matrix: the JAX package's
    frame (values, bounds, std_err, at_bound with its 1e-4 of the box's
    width, covariance and correlation in ``attrs``), PD and not PD (the
    pseudo-inverse, with the same warning)."""
    mf, ref = reference
    flat = TRUTH.copy()
    flat[8] = 0.0  # nugget_11 on its lower bound
    flat[5] = 0.02 + 5e-5  # len_scale_11 within 1e-4 of the box's width
    t_params = _params(flat)
    j_params = JParams.from_flat(flat, spec=JSpec(**SPEC_KW))
    eig, vec = np.linalg.eigh(ref["nu_off_half"])  # not PD: not at an optimum
    info = (vec * np.abs(eig)) @ vec.T
    not_pd = (vec * np.where(np.arange(11) == 0, -abs(eig[0]), np.abs(eig))) @ vec.T
    for m in (info, not_pd):
        caught = []
        for fn, params in ((nll_std_errors, t_params), (j_std_errors, j_params)):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                caught.append((fn(params, mf if fn is nll_std_errors else None,
                                  information=m), [str(x.message) for x in w]))
        (t, tw), (j, jw) = caught
        _frames_equal(t, j)
        assert tw == jw and len(tw) == (0 if m is info else 1)
        assert list(t["at_bound"]) == [i in (5, 8) for i in range(11)]
        assert np.isfinite(t["std_err"]).all()


def test_entry_points_default_to_the_card(reference, monkeypatch):
    mf, _ = reference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        observed_information(_params(TRUTH), mf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nll_std_errors(_params(TRUTH), mf)


def _staged_table(name, rng, cells, own_seed):
    """tests/test_cli.py's staged frame ([time, lat, lon, <name>,
    <name>_var], three months, smooth partially correlated signals) on
    ``cells`` of the 4 x 5-degree base grid."""
    import pandas as pd

    srng = np.random.default_rng(own_seed)
    base = (np.sin(np.deg2rad(cells[:, 0]) * 5) + 0.5 * np.cos(np.deg2rad(cells[:, 1]) * 3)
            + 0.6 * srng.normal(size=len(cells)))
    return pd.concat([pd.DataFrame({"time": pd.Timestamp(t), "lat": cells[:, 0],
                                    "lon": cells[:, 1], name: base + 0.15 * rng.normal(
                                        size=len(cells)) + 0.05 * k, f"{name}_var": 0.01})
                      for k, t in enumerate(["2018-04-01", "2018-05-01", "2018-06-01"])],
                     ignore_index=True)


def test_fit_std_errors_writes_the_jax_packages_table(tmp_path, capsys):
    """``python -m cokriging_tpu_torch fit --std-errors --device cpu``:
    ``<out>.std_errors.csv`` as the JAX CLI writes it (its step is
    ``nll_std_errors(params, mf)`` after the fit), against the JAX
    package's ``nll_std_errors`` at the parameters the port's fit wrote, on
    the MultiField the JAX CLI builds from the same staged tables (25 cells
    of the base grid per process: the JAX Hessian's compiled size). The
    information is not PD at a short WLS fit, so both take the
    pseudo-inverse; standard errors to 1e-6 relative (the Hessians agree to
    ~1e-13)."""
    import pandas as pd

    from cokriging_tpu.data.grids import main_coords_array
    from cokriging_tpu.fields import MultiField as JMultiField
    from cokriging_tpu.utils import io as JIO
    from cokriging_tpu_torch.__main__ import main as torch_main
    from cokriging_tpu_torch.utils import io as TIO

    cells = main_coords_array()[::5][:N]
    rng = np.random.default_rng(6)
    paths = []
    for k, name in enumerate(["xco2", "sif"]):
        paths.append(str(tmp_path / f"{name}.parquet"))
        TIO.save_table(paths[-1], _staged_table(name, rng, cells, 600 + k))
    out = tmp_path / "se.npz"
    torch_main(["fit", "--data", *paths, "--timestamp", "2018-05-01", "--timedeltas", "0", "0",
                "--max-dist", "3000", "--n-bins", "8", "--maxiter", "10", "--project-validity",
                "--std-errors", "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert printed.splitlines()[-1] == f"NLL-Hessian standard errors -> {out}.std_errors.csv"
    got = pd.read_csv(f"{out}.std_errors.csv")
    jmf = JMultiField.from_dataframes([JIO.load_table(p) for p in paths], ["xco2", "sif"],
                                      [["lon", "lat"]] * 2, timestamp="2018-05-01",
                                      timedeltas=[0, 0], main_coords=main_coords_array())
    assert [f.coords_main.shape[0] for f in jmf.fields] == [N, N]
    params = JIO.load_params(out)
    dists = j_blocks([f.coords_main for f in jmf.fields], geodesic=jmf.geodesic)
    info = _jax_info_of(params.to_flat(), dists, jnp.concatenate([f.values_main for f in
                                                                   jmf.fields]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_std_errors(params, jmf, information=info)
    assert list(got.columns) == list(want.columns) == ["name", "value", "bounds", "std_err",
                                                       "at_bound"]
    assert list(got["name"]) == list(want["name"])
    assert list(got["bounds"]) == [str(b) for b in want["bounds"]]
    assert list(got["at_bound"]) == list(want["at_bound"])
    np.testing.assert_allclose(got["value"], want["value"], rtol=1e-12)
    np.testing.assert_allclose(got["std_err"], want["std_err"], rtol=1e-6, atol=1e-9)
