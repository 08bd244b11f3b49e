"""The port's CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA card:

    python -m pytest -m gpu tests/test_torch_cuda.py

Without a card every test here skips (the check is made in a fixture).
"""

import numpy as np
import pytest
import torch

from cokriging_tpu_torch.estimate import empirical as E
from cokriging_tpu_torch.kernels import cuda_ops as K
from cokriging_tpu_torch.kernels.distance import haversine_matrix

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _points(rng, n, dtype, cuda):
    c = np.column_stack([rng.uniform(24, 50, n), rng.uniform(-124, -67, n)])
    return torch.as_tensor(c, dtype=dtype, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("marginal,covariogram,geodesic", [
    (True, False, True), (False, False, True), (False, True, True), (True, False, False),
])
def test_variogram_kernels_match_plain(cuda, dtype, marginal, covariogram, geodesic):
    rng = np.random.default_rng(7)
    n, m = 300, 300 if marginal else 257
    ca = _points(rng, n, dtype, cuda)
    cb = ca if marginal else _points(rng, m, dtype, cuda)
    if not geodesic:
        ca, cb = ca / 10.0, cb / 10.0
    va = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=cuda)
    vb = va if marginal else torch.as_tensor(rng.normal(size=m), dtype=dtype, device=cuda)
    fa, fb = E.point_features(ca, geodesic), E.point_features(cb, geodesic)
    max_d = 2000.0 if geodesic else 3.0
    np_dt = np.dtype(str(dtype).replace("torch.", ""))
    h_max = float(E._h_of_d(np_dt.type(max_d), geodesic))
    h_snap = float(E._h_of_d(np_dt.type(1e-6), geodesic))

    before = K.launch_counts()
    mm = K.variogram_minmax(fa, fb, marginal, geodesic, h_max, h_snap)
    assert torch.equal(mm, K.variogram_minmax_plain(fa, fb, marginal, geodesic, h_max, h_snap))
    _, h_edges = E._device_bins(*mm.cpu().numpy(), geodesic, np_dt.type(1e-6), 9, np_dt)
    he = torch.as_tensor(h_edges, device=cuda)
    s_k, n_k = K.variogram_bin(fa, fb, va, vb, he, marginal, geodesic, covariogram, h_max)
    s_p, n_p = K.variogram_bin_plain(fa, fb, va, vb, he, marginal, geodesic, covariogram, h_max)
    torch.cuda.synchronize()
    assert torch.equal(n_k, n_p)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(s_k, s_p, rtol=rtol, atol=1e-12)
    after = K.launch_counts()
    assert after["variogram_minmax"] == before["variogram_minmax"] + 1
    assert after["variogram_bin"] == before["variogram_bin"] + 1


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("nu,ls", [(0.5, 300.0), (1.5, 800.0), (2.7, 1500.0)])
def test_matern_kernel_matches_plain(cuda, dtype, atol, nu, ls):
    rng = np.random.default_rng(3)
    a = _points(rng, 333, dtype, cuda)
    b = _points(rng, 190, dtype, cuda)
    for h, sym in ((haversine_matrix(a, a), True), (haversine_matrix(a, b), False)):
        got = K.matern_correlation_block(nu, ls, h, symmetric=sym)
        ref = K.matern_correlation_block_plain(nu, ls, h, symmetric=sym)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, rtol=0.0, atol=atol)
        if sym:
            assert torch.equal(got, got.T)


def test_block_covariance_on_card_is_forward_only(cuda):
    from cokriging_tpu_torch.cov.matern import block_covariance
    from cokriging_tpu_torch.cov.params import MaternParams

    p = MaternParams.default(2, device=cuda)
    flat = p.to_flat().clone().requires_grad_(True)
    c = _points(np.random.default_rng(1), 40, torch.float64, cuda)
    d = haversine_matrix(c, c)
    with pytest.raises(NotImplementedError, match="slice 2"):
        block_covariance(p.with_flat(flat), [[d, d], [None, d]])
    out = block_covariance(p, [[d, d], [None, d]])
    ref = block_covariance(p.to("cpu"), [[d.cpu(), d.cpu()], [None, d.cpu()]])
    torch.testing.assert_close(out.cpu(), ref, rtol=0.0, atol=1e-12)
