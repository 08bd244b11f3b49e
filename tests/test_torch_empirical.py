"""Port variograms (the plain version of the variogram kernels) against the
JAX package's all-pairs program and its Pallas binning kernel."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cokriging_tpu.estimate import empirical as JE
from cokriging_tpu.kernels import pallas_ops as P
from cokriging_tpu_torch.estimate import empirical as TE
from cokriging_tpu_torch.kernels import cuda_ops as K

torch.set_num_threads(1)


def _fields(rng, n, geodesic):
    out = []
    for k in range(2):
        if geodesic:
            c = np.column_stack([rng.uniform(24, 50, n - 20 * k), rng.uniform(-124, -67, n - 20 * k)])
        else:
            c = rng.uniform(0, 10, size=(n - 20 * k, 2))
        c[:3] = c[3]  # duplicate points: exact-zero distances
        out.append((c, rng.normal(size=len(c))))
    return out


@pytest.mark.parametrize("geodesic,kind", [
    (True, "Semivariogram"), (True, "Covariogram"), (False, "Semivariogram"),
])
def test_variograms_match_all_pairs_program(geodesic, kind):
    rng = np.random.default_rng(5)
    (c1, v1), (c2, v2) = _fields(rng, 260, geodesic)
    max_dist = 2500.0 if geodesic else 6.0
    jcfg = JE.VarioConfig(max_dist=max_dist, n_bins=12, kind=kind, geodesic=geodesic)
    tcfg = TE.VarioConfig(max_dist=max_dist, n_bins=12, kind=kind, geodesic=geodesic)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, jc, jm, jn = JE.empirical_variograms_device([c1, c2], [v1, v2], jcfg)
        before = K.launch_counts()
        tp, tc, tm, tn = TE.empirical_variograms_device([c1, c2], [v1, v2], tcfg, device="cpu")
    assert K.launch_counts() == before
    assert list(tp) == list(jp)
    np.testing.assert_array_equal(tn, np.asarray(jn))
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-12)
    np.testing.assert_allclose(tm, np.asarray(jm), rtol=1e-8, atol=1e-12)


def test_edges_follow_jnp_linspace():
    """jnp.linspace's formula, operation by operation (inside a jitted
    program XLA may fuse it further, which moves results by an ulp)."""
    for dtype in (np.float32, np.float64):
        for a, b in ((12.3456789, 2987.654321), (0.0, 1.0), (1e-3, 7.0)):
            with jax.disable_jit():
                ref = np.asarray(jnp.linspace(jnp.asarray(a, dtype), jnp.asarray(b, dtype), 15))
            np.testing.assert_array_equal(TE._jnp_linspace(a, b, 15, np.dtype(dtype)), ref)
    for got, ref in zip(TE.variogram_bins(35.0, 1950.0, 9), JE.variogram_bins(35.0, 1950.0, 9)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("marginal,covariogram", [(False, False), (True, False)])
def test_plain_bin_pass_matches_pallas_kernel(rng, marginal, covariogram):
    """The bin kernel's plain version against ``variogram_bin_pallas`` in
    interpret mode (test_pallas_kernel.py's case), with the distance edges
    moved into h."""
    n, m = 280, 260
    ca = np.column_stack([rng.uniform(25, 50, n), rng.uniform(-120, -70, n)])
    cb = ca if marginal else np.column_stack([rng.uniform(25, 50, m), rng.uniform(-120, -70, m)])
    va = rng.normal(size=n)
    vb = va if marginal else rng.normal(size=len(cb))
    va, vb = va - va.mean(), vb - vb.mean()
    _, edges = JE.variogram_bins(35.0, 1950.0, 9)
    with pltpu.force_tpu_interpret_mode():
        ref_s, ref_n = P.variogram_bin_pallas(
            ca, va, cb, vb, edges, marginal, covariogram, 2000.0, True, 9
        )
    fa = TE.point_features(torch.as_tensor(ca), True)
    fb = TE.point_features(torch.as_tensor(cb), True)
    s, cnt = K.variogram_bin(
        fa, fb, torch.as_tensor(va), torch.as_tensor(vb),
        torch.as_tensor(TE._h_of_d(edges, True)), marginal, True, covariogram,
        float(TE._h_of_d(np.float64(2000.0), True)),
    )
    np.testing.assert_array_equal(cnt.numpy(), ref_n)
    got = np.where(ref_n > 0, s.numpy() / np.maximum(ref_n, 1), np.nan)
    np.testing.assert_allclose(got, np.where(ref_n > 0, ref_s / np.maximum(ref_n, 1), np.nan),
                               rtol=1e-8, equal_nan=True)


def test_no_pairs_within_max_dist_raises():
    c = np.array([[30.0, -100.0], [40.0, -80.0]])
    cfg = TE.VarioConfig(max_dist=10.0, n_bins=5)
    with pytest.raises(ValueError, match="No pairs"):
        TE.empirical_variograms_device([c, c], [np.ones(2), np.ones(2)], cfg, device="cpu")
