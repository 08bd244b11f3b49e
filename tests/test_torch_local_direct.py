"""The port's ``LocalPredictor(materialize_cov=False)``: local systems
assembled from gathered neighborhood coordinates, with the device search or
host kd-trees, against the materialized path and against the JAX package's
direct path, on the CPU in float64 (the bars of
``tests/test_local_direct_cov.py``)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams
from cokriging_tpu.cov import MultivariateMatern as JMod
from cokriging_tpu.cov.params import ParamSpec as JSpec
from cokriging_tpu.fields.field import Field as JField
from cokriging_tpu.fields.field import MultiField as JMultiField
from cokriging_tpu.predict import LocalPredictor as JLocalPredictor
from cokriging_tpu_torch.cov.matern import MultivariateMatern
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.kernels import cuda_ops as K
from cokriging_tpu_torch.predict.local import LocalPredictor
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

FLAT = np.array([1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.05, 0.05, -0.6])
MAX_DIST = 0.3


def _fields(coords, values, geodesic, cls_f, cls_mf):
    fields = []
    for k, (c, v) in enumerate(zip(coords, values)):
        f = cls_f.from_arrays(c, v, f"Z{k}")
        f.geodesic = geodesic
        fields.append(f)
    return cls_mf(fields=fields)


@pytest.fixture(scope="module")
def setup():
    """Two processes of 60 points in the unit square (a third of them
    colocated) and 57 grid locations, some on data points."""
    rng = np.random.default_rng(8)
    c1 = rng.uniform(0, 1, (60, 2))
    c2 = np.concatenate([c1[:20], rng.uniform(0, 1, (40, 2))])
    values = [rng.normal(size=60), rng.normal(size=60)]
    g = np.linspace(0.0, 1.0, 15)
    pc = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)[::4]
    pc[:3] = c1[:3]
    return [c1, c2], values, pc


def _assert_same(a, b):
    np.testing.assert_array_equal(np.isnan(a.pred), np.isnan(b.pred))
    np.testing.assert_allclose(b.pred, a.pred, rtol=1e-10, atol=1e-12)
    # pred_err at data-coincident locations is sqrt(var ~ 0): rounding in
    # the two assemblies (~1e-16) surfaces as ~1e-8 after the sqrt
    np.testing.assert_allclose(b.pred_err, a.pred_err, rtol=1e-8, atol=1e-7)


@pytest.mark.parametrize("i", [0, 1])
def test_direct_and_kd_match_materialized(setup, i):
    """Direct assembly with the device search and with kd-trees both equal
    the materialized joint-covariance path; the direct paths launch no
    joint-covariance block."""
    coords, values, pc = setup
    mod = MultivariateMatern(params=params_from_numpy(FLAT))
    mf = _fields(coords, values, False, Field, MultiField)
    want = LocalPredictor(mod, mf, device="cpu")(i, pc, max_dist=MAX_DIST, postprocess=False)
    lp_dir = LocalPredictor(mod, mf, device="cpu", materialize_cov=False)
    assert lp_dir.joint_cov is None
    _assert_same(want, lp_dir(i, pc, max_dist=MAX_DIST, postprocess=False))
    lp_kd = LocalPredictor(mod, mf, device="cpu", materialize_cov=False, neighbor_method="kd")
    got = lp_kd(i, pc, max_dist=MAX_DIST, postprocess=False)
    _assert_same(want, got)
    np.testing.assert_array_equal(got.n_neighbors, want.n_neighbors)


@pytest.mark.parametrize("method,i", [("device", 1), ("kd", 0)])
def test_direct_paths_match_jax(setup, method, i):
    coords, values, pc = setup
    mod = MultivariateMatern(params=params_from_numpy(FLAT))
    got = LocalPredictor(mod, _fields(coords, values, False, Field, MultiField), device="cpu",
                         materialize_cov=False, neighbor_method=method)(
        i, pc, max_dist=MAX_DIST, postprocess=False)
    jmod = JMod(params=JParams.from_flat(jnp.asarray(FLAT)))
    want = JLocalPredictor(jmod, _fields(coords, values, False, JField, JMultiField),
                           materialize_cov=False, neighbor_method=method)(
        i, pc, max_dist=MAX_DIST, postprocess=False)
    np.testing.assert_allclose(got.pred, want["pred"].values, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.pred_err, want["pred_err"].values, rtol=1e-8, atol=1e-7)


def test_kd_geodesic_matches_device_search_and_jax():
    """Geodesic coordinates: the sphere-embedded kd radius filter gives the
    haversine device search's neighborhoods, including an empty one (NaN on
    both paths and in the reference)."""
    rng = np.random.default_rng(4)
    lat, lon = rng.uniform(25, 50, 120), rng.uniform(-120, -70, 120)
    coords = [np.column_stack([lat, lon])]
    values = [np.sin(np.deg2rad(lat) * 5) + 0.1 * rng.normal(size=120)]
    pc = np.column_stack([rng.uniform(24, 51, 60), rng.uniform(-125, -65, 60)])
    pc[0] = [70.0, -40.0]  # far from every datum
    flat = np.array([1.0, 1.5, 400.0, 0.05])
    mod = MultivariateMatern(1, MaternParams.from_flat(torch.as_tensor(flat),
                                                       spec=ParamSpec(n_procs=1)))
    mf = _fields(coords, values, True, Field, MultiField)
    jmod = JMod(1, JParams.from_flat(jnp.asarray(flat), spec=JSpec(n_procs=1)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = LocalPredictor(mod, mf, device="cpu", materialize_cov=False)(
            0, pc, max_dist=500.0, postprocess=False)
        b = LocalPredictor(mod, mf, device="cpu", materialize_cov=False,
                           neighbor_method="kd")(0, pc, max_dist=500.0, postprocess=False)
        want = JLocalPredictor(jmod, _fields(coords, values, True, JField, JMultiField),
                               materialize_cov=False, neighbor_method="kd")(
            0, pc, max_dist=500.0, postprocess=False)
    assert np.isnan(a.pred[0]) and a.n_neighbors[0] == 0
    _assert_same(a, b)
    np.testing.assert_allclose(b.pred, want["pred"].values, rtol=1e-10, atol=1e-12)


def test_direct_path_runs_the_pairs_version_once_per_batch(setup, monkeypatch):
    """Each batch of local systems is one gathered-pairs evaluation (on the
    card, one kernel launch); the batch size follows the two ceilings."""
    coords, values, pc = setup
    calls = []
    plain = K.matern_corr_pairs_plain
    monkeypatch.setattr(K, "matern_corr_pairs_plain",
                        lambda *a: calls.append(a[3].shape) or plain(*a))
    mod = MultivariateMatern(params=params_from_numpy(FLAT))
    lp = LocalPredictor(mod, _fields(coords, values, False, Field, MultiField), device="cpu",
                        materialize_cov=False)
    lp(0, pc, max_dist=MAX_DIST, postprocess=False)
    assert len(calls) == 1 and calls[0][0] == len(pc) and calls[0][1] == calls[0][2]
    assert lp._batch_size((384, 384), 4000) == 128
