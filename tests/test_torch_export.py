"""The port's serving export (``utils/export.py``) against the live
direct-assembly ``LocalPredictor`` and against the JAX package's artifact,
on the CPU in float64 (the shape of ``tests/test_export.py``): the served
program equals the live predictor bit for bit, takes fresh parameters and
values, matches the JAX artifact at the JAX test's bar (rtol 1e-6 on finite
lanes), and its LOOCV form equals the live LOOCV; K_nu's fixed order count
changes no bit; the registered pairs op has a fake implementation. One
export per artifact, shared by the module (an export, save and load of the
f64 program take ~20 s on an 8-core CPU host)."""

import numpy as np
import pytest
import torch

from cokriging_tpu.cov import MaternParams as JParams
from cokriging_tpu.cov import MultivariateMatern as JMod
from cokriging_tpu.fields.field import Field as JField
from cokriging_tpu.fields.field import MultiField as JMultiField
from cokriging_tpu.predict import LocalPredictor as JLocalPredictor
from cokriging_tpu.utils import export as JE
from cokriging_tpu_torch.cov.matern import MultivariateMatern, matern_correlation
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.kernels import cuda_ops as K
from cokriging_tpu_torch.kernels.bessel import kv
from cokriging_tpu_torch.predict.local import LocalPredictor
from cokriging_tpu_torch.utils import export as TE
from cokriging_tpu_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

FLAT = np.array([1.0, 1.0, 1.5, 1.5, 1.5, 0.2, 0.2, 0.2, 0.01, 0.01, -0.6])
MAX_DIST = 0.3


def _fields(coords, values, cls_f, cls_mf):
    fields = []
    for k, (c, v) in enumerate(zip(coords, values)):
        f = cls_f.from_arrays(c, v, f"Z{k}")
        f.geodesic = False
        fields.append(f)
    return cls_mf(fields=fields)


def _data(scale0=1.0):
    """Two processes of 40 points in the unit square (half of them
    colocated), smooth signals plus noise, and 33 grid locations."""
    rng = np.random.default_rng(21)
    c1 = rng.uniform(0, 1, (40, 2))
    c2 = np.concatenate([c1[:20], rng.uniform(0, 1, (20, 2))])
    values = [scale0 * (np.sin(4 * c1[:, 0]) + 0.2 * rng.normal(size=40)),
              np.cos(3 * c2[:, 1]) + 0.2 * rng.normal(size=40)]
    g = np.linspace(0.0, 1.0, 15)
    pc = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)[::7]
    return [c1, c2], values, pc


def _predictor(flat, coords, values):
    mod = MultivariateMatern(params=params_from_numpy(flat))
    return LocalPredictor(mod, _fields(coords, values, Field, MultiField), device="cpu",
                          materialize_cov=False)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def served():
    """The artifact of process 0 at the grid locations, loaded, with its
    example arguments and the live predictor."""
    coords, values, pc = _data()
    lp = _predictor(FLAT, coords, values)
    blob = TE.export_local_prediction(lp, 0, pc, max_dist=MAX_DIST)
    _, args = TE.make_local_prediction_fn(lp, 0, pc, max_dist=MAX_DIST)
    return blob, TE.load_program(blob), args, lp


def test_export_roundtrip_matches_live_predictor(served):
    blob, fn, args, lp = served
    assert isinstance(blob, bytes) and len(blob) > 1000
    _, _, pc = _data()
    live = lp(0, pc, max_dist=MAX_DIST, postprocess=False)
    assert np.isfinite(live.pred).mean() > 0.9
    _equal(fn(*args), (live.pred, live.pred_err, live.n_neighbors))


def test_exported_artifact_takes_fresh_runtime_inputs(served):
    """New parameters and values flow through the same artifact: the
    answer changes and equals the live predictor on those inputs; a nu
    beyond the exported bound raises."""
    _, fn, (flat, pc, v0, v1), _ = served
    coords, values, pc_np = _data(scale0=0.5)
    a = fn(flat, pc, v0, v1)[0].numpy()
    b = fn(flat * 1.1, pc, v0 * 0.5, v1)
    ok = np.isfinite(a) & np.isfinite(b[0].numpy())
    assert ok.any() and not np.allclose(a[ok], b[0].numpy()[ok])
    live = _predictor(FLAT * 1.1, coords, values)(0, pc_np, max_dist=MAX_DIST, postprocess=False)
    _equal(b, (live.pred, live.pred_err, live.n_neighbors))
    beyond = flat.clone()
    beyond[2] = 3.6  # nu_11 past the default box's 3.5
    with pytest.raises(RuntimeError):
        fn(beyond, pc, v0, v1)


def test_served_matches_the_jax_artifact(served):
    _, fn, args, _ = served
    coords, values, pc = _data()
    jlp = JLocalPredictor(JMod(params=JParams.from_flat(FLAT)),
                          _fields(coords, values, JField, JMultiField), materialize_cov=False)
    jfn = JE.load_program(JE.export_local_prediction(jlp, 0, pc, max_dist=MAX_DIST))
    _, jargs = JE.make_local_prediction_fn(jlp, 0, pc, max_dist=MAX_DIST)
    want = [np.asarray(o) for o in jfn(*jargs)[:2]]
    got = [o.numpy() for o in fn(*args)[:2]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        ok = np.isfinite(w)
        assert ok.mean() > 0.9
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-6)


def test_cv_artifact_matches_live_loocv():
    """The LOOCV form (``cv=True``, requests at the data sites of process
    0) equals ``cross_validation`` bit for bit."""
    coords, values, _ = _data()
    lp = _predictor(FLAT, coords, values)
    sites = coords[0]
    fn = TE.load_program(TE.export_local_prediction(lp, 0, sites, max_dist=MAX_DIST, cv=True))
    _, args = TE.make_local_prediction_fn(lp, 0, sites, max_dist=MAX_DIST, cv=True)
    live = lp.cross_validation(0, max_dist=MAX_DIST, postprocess=False)
    assert np.isfinite(live.pred).all()
    _equal(fn(*args), (live.pred, live.pred_err, live.n_neighbors))


@pytest.mark.parametrize("nu", [3.5, 1.5, 2.2])
def test_static_order_count_changes_no_bit(nu):
    """K_nu and the Matern correlation with the exported fixed recurrence
    count (ceil of the box's nu bound, 4) against the live data-dependent
    count: nu at its bound, at a half-integer and in between."""
    x = torch.as_tensor(np.concatenate([np.geomspace(1e-3, 40.0, 300), [2.0]]))
    nus = torch.full_like(x, nu)
    np.testing.assert_array_equal(kv(nus, x, order_steps=4).numpy(), kv(nus, x).numpy())
    np.testing.assert_array_equal(matern_correlation(nu, 0.3, x, order_steps=4).numpy(),
                                  matern_correlation(nu, 0.3, x).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_registered_op_on_fake_tensors(dtype):
    """The op's fake implementation gives h's shape and dtype; its CPU
    implementation is the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        h = torch.empty(4, 9, 9, dtype=dtype)
        out = torch.ops.cokriging_tpu_torch.matern_corr_pairs(
            torch.empty(3, dtype=dtype), torch.empty(3, dtype=dtype), torch.empty_like(h), h,
            None, True)
        assert out.shape == h.shape and out.dtype == dtype
    rng = np.random.default_rng(3)
    args = (torch.tensor([0.5, 1.5, 2.7], dtype=dtype), torch.tensor([0.2, 0.5, 1.0], dtype=dtype),
            torch.as_tensor(rng.integers(0, 3, (4, 9)).astype(np.float64)).to(dtype),
            torch.as_tensor(rng.uniform(0, 2, (4, 9))).to(dtype))
    _equal([torch.ops.cokriging_tpu_torch.matern_corr_pairs(*args, None, True)],
           [K.matern_corr_pairs_plain(*args)])
