"""The port's million-point workflow
(``experiments/million_point_workflow.py``) against the JAX package, on the
CPU in float64 at small sizes: the JAX spectral simulator's normals in both
dtypes (``experiments/reference_draws.py`` against ``jax.random``) and its
field (``ReferenceSpectralField`` against ``SpectralRandomField``); the
Vecchia scaffold the workflow's fits build past 20,000 points (coarse order,
kd neighbours: the same permutation and neighbour windows) and its value and
gradient at the script's start; the direct-assembly local predictor at the
held-out cells. ``tests/test_torch_million_point_main.py`` runs ``main`` at
the JAX smoke test's sizes."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams
from cokriging_tpu.cov import MultivariateMatern as JMod
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.estimate import vecchia as JV
from cokriging_tpu.fields.field import Field as JField
from cokriging_tpu.fields.field import MultiField as JMultiField
from cokriging_tpu.predict import LocalPredictor as JLocalPredictor
from cokriging_tpu.sim import CartesianGrid as JGrid
from cokriging_tpu.sim import SpectralRandomField as JSpectral
from cokriging_tpu_torch.cov.matern import MultivariateMatern
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate import vecchia as TV
from cokriging_tpu_torch.experiments import million_point_workflow as W
from cokriging_tpu_torch.experiments import reference_draws as RD
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.predict.local import LocalPredictor
from cokriging_tpu_torch.sim import CartesianGrid

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_PER, GRID, M = 600, 48, 10  # the scaffold's sample: 2 x 600 on a 48 x 48 grid


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# --- (a) the draws ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 11, 2**40 + 7])
def test_normals_match_jax_random_normal(dtype, seed):
    """Both halves of a split key at small lengths, float32 also across a
    numpy pass's chunk: float64 within 1e-14 (scipy's erfinv against
    XLA's), float32 within 2 ulp (bit for bit where XLA's float32
    arithmetic is the one copied)."""
    keys = RD.split(RD.prng_key(seed))
    jkeys = jax.random.split(jax.random.PRNGKey(seed))
    for k, jk in zip(keys, jkeys):
        for n in (1, 1001) + ((RD._CHUNK + 3,) if dtype == np.float32 else ()):
            got = RD.normal(k, n, dtype)
            want = np.asarray(jax.random.normal(jk, (n,), dtype))
            assert got.dtype == want.dtype == np.dtype(dtype)
            if dtype == np.float64:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * np.abs(want).max())
            else:
                assert _ulps(got, want).max() <= 2


def test_float32_erf_inv_tails_match_xla():
    """XLA's float32 erf_inv and log1p at the uniforms' extremes and across
    both polynomial branches (w < 5 and w >= 5), within 2 ulp."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.concatenate([np.array([lo, -lo, 0.0, 1e-30, -0.5, 0.9999, -0.99999], np.float32),
                        np.linspace(lo, -lo, 20001, dtype=np.float32)])
    got = RD._erf_inv32(u)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    assert _ulps(got, want).max() <= 2
    x = (-u * u).astype(np.float32)
    assert _ulps(RD._log1p32(x), np.asarray(jnp.log1p(jnp.asarray(x)))).max() <= 2


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spectral_normals_are_jax_draws(dtype):
    """``ReferenceSpectralField._eps``: the real and imaginary parts are
    ``jax.random.normal`` of the two halves of ``split(PRNGKey(seed))`` at
    the simulator's (n_draw, mx, my, p) shape, as
    ``cokriging_tpu/sim/spectral.py:_draw`` draws them."""
    tm = MultivariateMatern(params=MaternParams.from_flat(
        torch.tensor(W.TRUTH, dtype=torch.float64), spec=ParamSpec(2, **W.BOUNDS)))
    rf = RD.ReferenceSpectralField(tm, CartesianGrid((0, 100), (0, 100), 9, 9, device="cpu"),
                                   seed=4, normals=dtype, device="cpu")
    eps = rf._eps(13, 2)
    shape = (2, rf._mx, rf._my, 2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(13))
    for got, k in ((eps.real, k1), (eps.imag, k2)):
        want = np.asarray(jax.random.normal(k, shape, dtype))
        assert tuple(got.shape) == shape and got.dtype == torch.float64
        if dtype == np.float32:
            assert _ulps(got.numpy().astype(dtype), want).max() <= 2
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14 * np.abs(want).max())


@pytest.fixture(scope="module")
def fields32():
    """The workflow's truth on a 32 x 32 grid of [0, 100]^2 in both
    packages (the JAX one on the CPU: float64 normals)."""
    jspec = JSpec(2, **W.BOUNDS)
    jm = JMod(params=JParams.from_flat(jnp.asarray(W.TRUTH), spec=jspec))
    jf = JSpectral(jm, JGrid(xbounds=(0, 100), ybounds=(0, 100), xcount=32, ycount=32),
                   seed=W.FIELD_SEED)
    rf, grid, _ = W.simulate(32, 100, np.float64, torch.device("cpu"))
    return jf, rf


def test_reference_spectral_field_matches_jax(fields32):
    """The truth fields within 1e-12 and the sample (with measurement
    error, to hold the noise draws too) within 1e-12."""
    jf, rf = fields32
    assert (rf._mx, rf._my) == (jf._mx, jf._my) == (64, 64)
    for a, b in zip(rf.fields, jf.fields):
        np.testing.assert_array_equal(a[["x", "y"]].values, b[["x", "y"]].values)
        np.testing.assert_allclose(a["value"].values, b["value"].values, rtol=0, atol=1e-12)
    got = rf.sample(size=200, epsilon=[0.1, 0.2], seed=W.SAMPLE_SEED)
    want = jf.sample(size=200, epsilon=[0.1, 0.2], seed=W.SAMPLE_SEED)
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a[["x", "y"]].values, b[["x", "y"]].values)
        np.testing.assert_allclose(a[f"Z{k}"].values, b[f"Z{k}"].values, rtol=0, atol=1e-12)


# --- (b) the Vecchia scaffold and its likelihood --------------------------------


@pytest.fixture(scope="module")
def sample():
    """2 x 600 observations of the workflow's field (48 x 48 grid) and the
    held-out cells of its prediction stage, as numpy arrays."""
    rf, grid, mf = W.simulate(GRID, N_PER, np.float64, torch.device("cpu"))
    coords = [f.coords.numpy() for f in mf.fields]
    values = [f.values.numpy() for f in mf.fields]
    pc, z_true = W.held_out_cells(rf, grid, N_PER, 100, np.float64)
    return coords, values, pc, z_true


@pytest.mark.parametrize("exact_prefix", [4096, 64])
def test_coarse_kd_scaffold_and_value_gradient_match_jax(sample, exact_prefix):
    """The scaffold "auto" builds past 20,000 points, forced here: the same
    permutation and the same windows (neighbour sets included, integer
    equality) under the default 4,096-row exact prefix and a 64-row one
    (the doubling kd blocks); the value and gradient at the script's start
    within 1e-10 relative."""
    coords, values, _, _ = sample
    kw = dict(m=M, geodesic=False, ordering="coarse", neighbor_method="kd",
              kd_exact_prefix=exact_prefix)
    lik = TV.VecchiaLikelihood(coords, values, device="cpu", **kw)
    jlik = JV.VecchiaLikelihood(coords, values, **kw)
    np.testing.assert_array_equal(lik.perm, jlik.perm)
    for a, b in zip(lik._win, jlik._win):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(lik.scaffold) == {"order_s", "neighbors_s", "windows_s", "window_bytes"}
    v, g = TV.vecchia_nll_value_and_grad(torch.tensor(W.INIT, dtype=torch.float64), lik._win,
                                         ParamSpec(2, **W.BOUNDS), False)
    jv, jg = JV.vecchia_nll_value_and_grad(jnp.asarray(W.INIT), jlik._win,
                                           JSpec(2, **W.BOUNDS), False)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-10)
    jg = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-10, atol=1e-10 * np.abs(jg).max())


# --- (c) direct-assembly local prediction ---------------------------------------


def test_direct_local_prediction_matches_jax(sample):
    """``LocalPredictor(materialize_cov=False)`` under the truth at 100
    held-out cells within the CPU run's max_dist, with the kd neighbour
    search of the 1,000,000-point path: pred and pred_err within 1e-8 of
    the JAX package's."""
    coords, values, pc, _ = sample
    spec = ParamSpec(2, **W.BOUNDS)
    tm = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(W.TRUTH, dtype=torch.float64), spec=spec))
    jm = JMod(params=JParams.from_flat(jnp.asarray(W.TRUTH), spec=JSpec(2, **W.BOUNDS)))
    mf = MultiField(fields=[Field.from_arrays(c, v, f"Z{k}")
                            for k, (c, v) in enumerate(zip(coords, values))])
    jmf = JMultiField(fields=[JField.from_arrays(c, v, f"Z{k}")
                              for k, (c, v) in enumerate(zip(coords, values))])
    max_dist = W.CPU_SIZES["max_dist"]
    got = LocalPredictor(tm, mf, materialize_cov=False, neighbor_method="kd", device="cpu")(
        1, pc, max_dist=max_dist, postprocess=False)
    want = JLocalPredictor(jm, jmf, materialize_cov=False, neighbor_method="kd")(
        1, pc, max_dist=max_dist, postprocess=False)
    assert np.isfinite(got.pred).all() and got.n_neighbors.min() > 0
    np.testing.assert_allclose(got.pred, want["pred"].values, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.pred_err, want["pred_err"].values, rtol=0, atol=1e-8)


# --- the module's constants and sizes -------------------------------------------


def test_manifest_copy_equals_the_jax_manifest():
    """``JAX_MANIFEST`` is ``results/million_point_workflow.json``'s values,
    and the script's truth, box and start are the JAX script's."""
    ref = json.loads((ROOT / "results" / "million_point_workflow.json").read_text())
    for key, value in W.JAX_MANIFEST.items():
        if isinstance(value, dict):
            assert {k: ref[key][k] for k in value} == value, key
        else:
            assert ref[key] == value, key
    assert ref["truth_flat"] == W.TRUTH
    src = (ROOT / "examples" / "million_point_workflow.py").read_text()
    assert "TRUTH = [1.0, 1.0, 1.5, 1.5, 1.5, 5.0, 5.0, 5.0, 0.05, 0.05, -0.6]" in src
    assert "[1.0, 1.0, 1.0, 1.0, 1.0, 8.0, 8.0, 8.0, 0.1, 0.1, 0.0]" in src
    for name, bounds in W.BOUNDS.items():
        assert f"{name}={bounds}" in src


def test_sizes_follow_the_device_and_the_environment(monkeypatch):
    for var in W.ENV.values():
        monkeypatch.delenv(var, raising=False)
    assert W.sizes_for(torch.device("cpu")) == W.CPU_SIZES
    assert W.sizes_for(torch.device("cuda")) == W.CARD_SIZES
    monkeypatch.setenv("MPW_N", "400")
    monkeypatch.setenv("MPW_MAXITER", "25")
    s = W.sizes_for(torch.device("cuda"), n_hold=7)
    assert (s["n_per"], s["maxiter_full"], s["n_hold"], s["grid"]) == (400, 25, 7, 1024)
    with pytest.raises(TypeError):
        W.sizes_for(torch.device("cpu"), nx=3)
