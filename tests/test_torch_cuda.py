"""The port's CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA card:

    python -m pytest -m gpu tests/test_torch_cuda.py

Without a card every test here skips (the check is made in a fixture).
"""

import math

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


def test_variogram_bin_takes_40_bins(cuda):
    """More bins than the kernel's shared-memory histogram holds: one pair
    pass per window of bins, exact counts, two launches."""
    rng = np.random.default_rng(8)
    dtype = torch.float64
    ca, cb = _points(rng, 700, dtype, cuda), _points(rng, 513, dtype, cuda)
    va = torch.as_tensor(rng.normal(size=700), dtype=dtype, device=cuda)
    vb = torch.as_tensor(rng.normal(size=513), dtype=dtype, device=cuda)
    fa, fb = E.point_features(ca, True), E.point_features(cb, True)
    h_max = float(E._h_of_d(np.float64(2500.0), True))
    h_snap = float(E._h_of_d(np.float64(1e-6), True))
    for marginal, (fb_, vb_) in ((True, (fa, va)), (False, (fb, vb))):
        mm = K.variogram_minmax(fa, fb_, marginal, True, h_max, h_snap)
        _, h_edges = E._device_bins(*mm.cpu().numpy(), True, np.float64(1e-6), 40, np.dtype("f8"))
        he = torch.as_tensor(h_edges, device=cuda)
        before = K.launch_counts()["variogram_bin"]
        s_k, n_k = K.variogram_bin(fa, fb_, va, vb_, he, marginal, True, False, h_max)
        s_p, n_p = K.variogram_bin_plain(fa, fb_, va, vb_, he, marginal, True, False, h_max)
        torch.cuda.synchronize()
        assert n_k.shape == (40,) and torch.equal(n_k, n_p)
        torch.testing.assert_close(s_k, s_p, rtol=1e-12, atol=1e-12)
        assert K.launch_counts()["variogram_bin"] == before + 2


def _on_edge_bins(fa, fb, marginal, geodesic, h_max, n_bins, dtype):
    """n_bins + 1 h-edges drawn from the variogram's own valid h values, the
    first pulled to 0, so that pairs lie exactly on edges (fixed edges for a
    variogram without pairs)."""
    h = K.h_block(fa, fb, geodesic)
    valid = h <= h_max
    if marginal:
        valid &= torch.ones_like(valid).triu(1)
    hv = torch.unique(h[valid]).cpu().numpy()
    np_dt = np.dtype(str(dtype).removeprefix("torch."))
    if hv.size < n_bins + 1:
        return np.linspace(0.0, h_max, n_bins + 1).astype(np_dt)
    edges = hv[np.linspace(0, hv.size - 1, n_bins + 1).round().astype(int)]
    edges[0] = 0.0
    return edges.astype(np_dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geodesic,covariogram", [(True, False), (True, True), (False, False)])
def test_variogram_pairs_launch_stress(cuda, dtype, geodesic, covariogram):
    """All 36 variograms of eight processes of 1, 127, 128, 129, 255, 256, 257
    and 513 points (around the kernel's 256-point tiles; duplicated points
    give h = 0) in one call per pass (two launches each: 32 variograms per
    launch), at 15 and 40 bins (one and two windows) with edges on pairs, and
    at 15 edges of one value after 0 (the lookup's many-compare path):
    h ranges equal to the one-variogram launches and the plain version;
    counts equal to the plain version's, sums within rtol 1e-5 / 1e-12; the
    multi-variogram sums and counts bit-equal to the one-variogram launches'
    and to a second call's."""
    rng = np.random.default_rng(17)
    ns = [1, 127, 128, 129, 255, 256, 257, 513]
    pts = [_points(rng, n, dtype, cuda) for n in ns]
    for k in range(2, len(pts)):
        pts[k][:3] = pts[k - 1][:3]
    if not geodesic:
        pts = [p / 10.0 for p in pts]
    feats = [E.point_features(p, geodesic).contiguous() for p in pts]
    vals = [torch.as_tensor(rng.normal(size=n), dtype=dtype, device=cuda) for n in ns]
    np_dt = np.dtype(str(dtype).removeprefix("torch."))
    h_max = float(E._h_of_d(np_dt.type(2000.0 if geodesic else 3.0), geodesic))
    h_snap = float(E._h_of_d(np_dt.type(1e-6), geodesic))
    pairs = [(i, j) for i in range(len(ns)) for j in range(i, len(ns))]
    mm_sides = [(feats[i], feats[j], i == j) for i, j in pairs]
    before = K.launch_counts()
    mm = K.variogram_minmax_pairs(mm_sides, geodesic, h_max, h_snap)
    assert K.launch_counts()["variogram_minmax"] == before["variogram_minmax"] + 2
    assert torch.equal(mm, K.variogram_minmax_pairs_plain(mm_sides, geodesic, h_max, h_snap))
    assert torch.equal(mm, torch.stack([K.variogram_minmax(*s, geodesic, h_max, h_snap)
                                        for s in mm_sides]))
    sides = [(feats[i], feats[j], vals[i], vals[j], i == j) for i, j in pairs]
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for n_bins in (15, 40, "same"):
        if n_bins == "same":
            n_bins = 14
            edges = [np.r_[0.0, np.full(n_bins, 0.25 * h_max)].astype(np_dt) for _ in pairs]
            assert K._bin_record(edges[0], True, True, np_dt)[1] == n_bins
        else:
            edges = [_on_edge_bins(feats[i], feats[j], i == j, geodesic, h_max, n_bins, dtype)
                     for i, j in pairs]
        before = K.launch_counts()["variogram_bin"]
        s_k, n_k = K.variogram_bin_pairs(sides, edges, geodesic, covariogram, h_max)
        assert K.launch_counts()["variogram_bin"] == before + 2 * (1 if n_bins <= 24 else 2)
        s_p, n_p = K.variogram_bin_pairs_plain(sides, edges, geodesic, covariogram, h_max)
        torch.cuda.synchronize()
        assert torch.equal(n_k, n_p), n_bins
        torch.testing.assert_close(s_k, s_p, rtol=rtol, atol=1e-12)
        one = [K.variogram_bin(*s[:4], e, s[4], geodesic, covariogram, h_max)
               for s, e in zip(sides, edges)]
        assert torch.equal(s_k, torch.stack([a for a, _ in one]))
        assert torch.equal(n_k, torch.stack([b for _, b in one]))
        again = K.variogram_bin_pairs(sides, edges, geodesic, covariogram, h_max)
        assert torch.equal(again[0], s_k) and torch.equal(again[1], n_k)
        assert int(n_k.sum()) > 0


def test_variogram_device_path_reads_once(cuda, monkeypatch):
    """``empirical_variograms_device`` on the card: one launch per pass for
    all three variograms, one host read of the h ranges between the passes
    (and one of the results), counts equal to the CPU run's; centers and
    means within 1e-12 (the point features' sin and cos differ by an ulp
    between the card and the CPU)."""
    rng = np.random.default_rng(5)
    coords = [_points(rng, 600, torch.float64, "cpu").numpy() for _ in range(2)]
    values = [rng.normal(size=600) for _ in range(2)]
    cfg = E.VarioConfig(max_dist=2500.0, n_bins=15)
    reads = []
    to_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: reads.append(t.shape) or to_cpu(t, *a, **k))
    before = K.launch_counts()
    _, c_k, m_k, n_k = E.empirical_variograms_device(coords, values, cfg, device=cuda)
    after = K.launch_counts()
    monkeypatch.undo()
    assert after["variogram_minmax"] - before["variogram_minmax"] == 1
    assert after["variogram_bin"] - before["variogram_bin"] == 1
    assert reads == [(3, 2), (3, 15), (3, 15)]
    _, c_p, m_p, n_p = E.empirical_variograms_device(coords, values, cfg, device="cpu")
    np.testing.assert_array_equal(n_k, n_p)
    np.testing.assert_allclose(c_k, c_p, rtol=1e-12)
    np.testing.assert_allclose(m_k, m_p, rtol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("nu,ls", [(0.3, 300.0), (0.5, 300.0), (1.5, 800.0), (2.7, 1500.0)])
def test_block_grad_kernel_matches_plain(cuda, dtype, tol, nu, ls):
    """The four sums against the plain version, each within tol * sum of
    |terms| (the sums cancel, so their own size is no yardstick): a ragged
    full block with exact zeros read through a row stride, and a symmetric
    block with an asymmetric cotangent, which also equals the full
    evaluation."""
    rng = np.random.default_rng(4)
    a = _points(rng, 300, dtype, cuda)
    b = torch.cat([a[:7], _points(rng, 510, dtype, cuda)])
    wide = haversine_matrix(a, torch.cat([b, b]))
    h = wide[:, :517]  # row stride 1034
    assert int((h == 0).sum()) == 7
    hs = haversine_matrix(a, a)
    for hh, sym in ((h, False), (hs, True), (hs, False)):
        ct = torch.as_tensor(rng.normal(size=tuple(hh.shape)), dtype=dtype, device=cuda)
        before = K.launch_counts()["matern_block_grad"]
        got = K.matern_block_grad(1.7, 0.05, nu, ls, hh, ct, symmetric=sym)
        torch.cuda.synchronize()
        assert K.launch_counts()["matern_block_grad"] == before + 1
        ref = K.matern_block_grad_plain(1.7, 0.05, nu, ls, hh, ct, symmetric=sym)
        mag = K.matern_block_grad_plain(1.7, 0.05, nu, ls, hh, ct, symmetric=sym, absolute=True)
        assert got.dtype == torch.float64 and torch.isfinite(got).all()
        assert bool(((got - ref).abs() <= tol * mag).all()), (got, ref, mag)
        if sym:
            full = K.matern_block_grad(1.7, 0.05, nu, ls, hh, ct)
            assert bool(((got - full).abs() <= tol * mag).all()), (got, full, mag)
            again = K.matern_block_grad(1.7, 0.05, nu, ls, hh, ct, symmetric=True)
            assert torch.equal(got, again)  # fixed-order sums


def test_block_covariance_on_card_is_forward_only(cuda):
    """Despite its name (kept from when the card had no backward):
    ``block_covariance`` is differentiable on the card, forward through the
    Matern kernel and backward through the block-gradient kernel, and its
    value and flat gradient agree with the CPU in both dtypes."""
    for dtype, rtol in ((torch.float32, 2e-3), (torch.float64, 1e-9)):
        _block_covariance_card_vs_cpu(cuda, dtype, rtol)


def _block_covariance_card_vs_cpu(cuda, dtype, rtol):
    from cokriging_tpu_torch.cov.matern import block_covariance
    from cokriging_tpu_torch.cov.params import MaternParams

    rng = np.random.default_rng(1)
    c = _points(rng, 40, dtype, cuda)
    d = haversine_matrix(c, c)
    w = torch.as_tensor(rng.normal(size=(80, 80)), dtype=dtype, device=cuda)
    x = torch.tensor([1.2, 0.8, 1.4, 1.1, 2.0, 300, 250, 350, 0.04, 0.02, -0.5], dtype=dtype)
    out = {}
    for dev in ("cuda", "cpu"):
        flat = x.to(dev).requires_grad_(True)
        dd = d.to(dev)
        before = K.launch_counts()
        cov = block_covariance(MaternParams.from_flat(flat), [[dd, dd], [None, dd]])
        (g,) = torch.autograd.grad((cov * w.to(dev)).sum(), flat)
        after = K.launch_counts()
        grew = {k: after[k] - before[k] for k in ("matern_correlation", "matern_block_grad")}
        assert grew == ({"matern_correlation": 3, "matern_block_grad": 3} if dev == "cuda"
                        else {"matern_correlation": 0, "matern_block_grad": 0})
        out[dev] = (cov.detach().cpu(), g.cpu())
    atol = 1e-12 if dtype == torch.float64 else 5e-6
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0.0, atol=atol)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=rtol,
                               atol=1e-10 if dtype == torch.float64 else 1e-3)


def _pairs_case(rng, n_pairs, dtype, cuda, n=70_001):
    """A ragged flat set of entries with exact zeros, spanning x = 2 at
    every pair, nu in {0.3, 0.5, 1.5, 2.7, ...}."""
    nu = [0.3, 0.5, 1.5, 2.7, 1.2, 0.8][:n_pairs]
    ls = [300.0, 300.0, 800.0, 1500.0, 450.0, 600.0][:n_pairs]
    h = np.abs(rng.normal(size=n)) * 1500.0
    h[::53] = 0.0
    idx = rng.integers(0, n_pairs, size=n).astype(np.float64)
    t = {k: torch.as_tensor(v, dtype=dtype, device=cuda)
         for k, v in (("h", h), ("idx", idx), ("ct", rng.normal(size=n)))}
    return (torch.tensor(nu, dtype=dtype), torch.tensor(ls, dtype=dtype)), t


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n_pairs", [1, 3, 6])
def test_pairs_kernel_matches_plain(cuda, dtype, atol, n_pairs):
    rng = np.random.default_rng(9)
    (nu, ls), t = _pairs_case(rng, n_pairs, dtype, cuda)
    before = K.launch_counts()["matern_corr_pairs"]
    got = K.matern_corr_pairs(nu, ls, t["idx"], t["h"])
    torch.cuda.synchronize()
    assert K.launch_counts()["matern_corr_pairs"] == before + 1
    ref = K.matern_corr_pairs_plain(nu, ls, t["idx"], t["h"])
    assert torch.isfinite(got).all() and got.shape == t["h"].shape
    torch.testing.assert_close(got, ref, rtol=0.0, atol=atol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n_pairs", [1, 3, 6])
def test_pairs_grad_kernel_matches_plain(cuda, dtype, tol, n_pairs):
    """Each per-pair sum within tol * sum of |terms| of the plain version,
    and the same sums bit for bit on a second launch."""
    rng = np.random.default_rng(10)
    (nu, ls), t = _pairs_case(rng, n_pairs, dtype, cuda)
    args = (nu, ls, t["idx"], t["h"], t["ct"])
    before = K.launch_counts()["matern_corr_pairs_grad"]
    got = K.matern_corr_pairs_grad(*args)
    torch.cuda.synchronize()
    assert K.launch_counts()["matern_corr_pairs_grad"] == before + 1
    ref = K.matern_corr_pairs_grad_plain(*args)
    mag = K.matern_corr_pairs_grad_plain(*args, absolute=True)
    assert got.shape == (n_pairs, 2) and got.dtype == torch.float64 and torch.isfinite(got).all()
    assert bool(((got - ref).abs() <= tol * mag).all()), (got, ref, mag)
    assert torch.equal(got, K.matern_corr_pairs_grad(*args))


def test_gathered_covariances_on_card_match_cpu(cuda):
    """``windows_covariance`` differentiated on the card (pairs forward and
    gradient kernels, one launch each) against the CPU's plain autograd."""
    from cokriging_tpu_torch.cov.matern import windows_covariance
    from cokriging_tpu_torch.cov.params import MaternParams

    rng = np.random.default_rng(11)
    coords = torch.as_tensor(rng.uniform(0, 1500, size=(40, 11, 2)))
    dists = torch.cdist(coords, coords)  # on the host, the same on both sides
    procs = torch.as_tensor(rng.integers(0, 2, size=(40, 11)))
    w = torch.as_tensor(rng.normal(size=(40, 11, 11)))
    x = torch.tensor([1.2, 0.8, 1.4, 1.1, 2.0, 300, 250, 350, 0.04, 0.02, -0.5],
                     dtype=torch.float64)
    out = {}
    for dev in ("cuda", "cpu"):
        flat = x.to(dev).requires_grad_(True)
        before = K.launch_counts()
        cov = windows_covariance(MaternParams.from_flat(flat), dists.to(dev), procs.to(dev))
        (g,) = torch.autograd.grad((cov * w.to(dev)).sum(), flat)
        after = K.launch_counts()
        grew = [after[k] - before[k] for k in ("matern_corr_pairs", "matern_corr_pairs_grad")]
        assert grew == ([1, 1] if dev == "cuda" else [0, 0])
        out[dev] = (cov.detach().cpu(), g.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0.0, atol=1e-12)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-9, atol=1e-10)


def _ulp_nus(dtype):
    """Half-integer orders (degenerate CF2 lanes) and 1.5 -+ one ulp of the
    dtype (the reference's truncated CF2 tangent)."""
    ft = np.float32 if dtype == torch.float32 else np.float64
    return [0.5, 1.5, 2.5, float(np.nextafter(ft(1.5), ft(0))), float(np.nextafter(ft(1.5), ft(2)))]


def _partition_cases(rng, dtype, mixed=6_145):
    """Flat entry sets that stress the pairs kernels' tile partition: one
    branch only (x < 2, x >= 2), a shuffled 50/50 mix, ten pairs, lengths
    around the 2,048-entry tile and ``mixed`` entries of both branches;
    each (name, nu list, ls list, idx, h)."""
    nus = [0.3, 0.5, 1.5, 2.5, 1.2] + _ulp_nus(dtype)
    lss = [300.0, 450.0, 800.0, 1500.0, 600.0, 350.0, 900.0, 1200.0, 700.0, 500.0]
    x_lo = rng.uniform(1e-3, 1.99, max(40_000, mixed))
    x_hi = rng.uniform(2.0, 40.0, max(40_000, mixed))
    cases = []
    for name, x, n_pairs in (("series only", x_lo, 5), ("CF2 only", x_hi, 5),
                             ("50/50 shuffled", rng.permutation(np.concatenate([x_lo, x_hi])), 10),
                             ("ten pairs", np.concatenate([x_lo, x_hi]), 10),
                             ("one entry", x_hi[:1], 1), ("2,047", x_lo[:2047], 3),
                             ("2,049", x_hi[:2049], 3), (f"{mixed:,} mixed", np.concatenate(
                                 [x_lo[:mixed // 2], x_hi[:mixed - mixed // 2]]), 10)):
        idx = rng.integers(0, n_pairs, size=x.shape[0])
        nu, ls = np.array(nus[:n_pairs]), np.array(lss[:n_pairs])
        h = x * ls[idx] / np.sqrt(2.0 * nu[idx])
        h[::97] = 0.0
        cases.append((name, nus[:n_pairs], lss[:n_pairs], idx.astype(np.float64), h))
    return cases


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_pairs_forward_partition_stress(cuda, dtype, atol):
    """The partitioned forward against its plain version where the tile's
    buckets are one, few or many, at half-integer nu and 1.5 -+ ulp; its
    output bit-equal under a random permutation of the entries, and with
    the degenerate lanes' CF2 trips run in full."""
    rng = np.random.default_rng(21)
    for name, nu, ls, idx, h in _partition_cases(rng, dtype):
        nu_t, ls_t = (torch.tensor(v, dtype=dtype, device=cuda) for v in (nu, ls))
        idx_t, h_t = (torch.as_tensor(v, dtype=dtype, device=cuda) for v in (idx, h))
        got = K.matern_corr_pairs(nu_t, ls_t, idx_t, h_t)
        ref = K.matern_corr_pairs_plain(nu_t, ls_t, idx_t, h_t)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), name
        assert float((got - ref).abs().max()) <= atol, name
        perm = torch.randperm(h_t.numel(), device=cuda)
        back = torch.empty_like(got)
        back[perm] = K.matern_corr_pairs(nu_t, ls_t, idx_t[perm], h_t[perm])
        assert torch.equal(back, got), name
        full = K.matern_corr_pairs(nu_t, ls_t, idx_t, h_t, early_exit=False)
        assert torch.equal(full, got), name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_block_grad_partition_stress(cuda, dtype, tol):
    """The partitioned block gradient against its plain version on blocks
    whose tiles are all series, all CF2 or a shuffled mix, ragged against
    the 64 x 64 tile, at half-integer nu and 1.5 -+ ulp: each sum within
    tol * sum |terms|, bit-equal on a second launch, symmetric == full."""
    rng = np.random.default_rng(22)
    for nu in _ulp_nus(dtype):
        ls = 800.0
        for name, lo, hi in (("series only", 1e-3, 1.99), ("CF2 only", 2.0, 40.0),
                             ("mixed", 1e-3, 40.0)):
            n = 197
            x = rng.uniform(lo, hi, size=(n, n))
            x = np.tril(x, -1) + np.tril(x, -1).T  # symmetric, zero diagonal
            h = torch.as_tensor(x * ls / np.sqrt(2.0 * nu), dtype=dtype, device=cuda)
            ct = torch.as_tensor(rng.normal(size=(n, n)), dtype=dtype, device=cuda)
            for hh, cc, sym in ((h, ct, True), (h[:, :131], ct[:, :131].contiguous(), False)):
                got = K.matern_block_grad(1.3, 0.02, nu, ls, hh, cc, symmetric=sym)
                ref = K.matern_block_grad_plain(1.3, 0.02, nu, ls, hh, cc, symmetric=sym)
                mag = K.matern_block_grad_plain(1.3, 0.02, nu, ls, hh, cc, symmetric=sym,
                                                absolute=True)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), (nu, name)
                assert bool(((got - ref).abs() <= tol * mag).all()), (nu, name, got, ref, mag)
                assert torch.equal(got, K.matern_block_grad(1.3, 0.02, nu, ls, hh, cc,
                                                            symmetric=sym)), (nu, name)
                if sym:
                    full = K.matern_block_grad(1.3, 0.02, nu, ls, hh, cc)
                    assert bool(((got - full).abs() <= tol * mag).all()), (nu, name)


def test_pairs_call_and_cg_matvec_do_not_synchronize(cuda):
    """One ``matern_corr_pairs`` call (table built on the card) and one CG
    matvec over its row tiles with the pair table built beforehand run
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    from cokriging_tpu_torch.cov.matern import pair_table
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.predict.iterative import _tiled_rows_matvec

    rng = np.random.default_rng(23)
    coords = _points(rng, 1200, torch.float64, cuda)
    procs = torch.as_tensor(rng.integers(0, 2, 1200), device=cuda)
    params = MaternParams.from_flat(torch.tensor(
        [1.2, 0.8, 1.4, 1.1, 2.0, 300, 250, 350, 0.04, 0.02, -0.5], dtype=torch.float64,
        device=cuda))
    table = pair_table(params, cuda, torch.float64)
    V = torch.as_tensor(rng.normal(size=(1200, 4)), device=cuda)
    nu = torch.tensor([0.7, 1.5], dtype=torch.float64, device=cuda)
    ls = torch.tensor([300.0, 800.0], dtype=torch.float64, device=cuda)
    h = torch.as_tensor(np.abs(rng.normal(size=50_000)) * 900.0, device=cuda)
    idx = torch.as_tensor(rng.integers(0, 2, 50_000).astype(np.float64), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = K.matern_corr_pairs(nu, ls, idx, h)
        y = _tiled_rows_matvec(params, coords, procs, coords, procs, V, True, 512, table)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(out, K.matern_corr_pairs_plain(nu, ls, idx, h), rtol=0.0, atol=1e-12)
    want = _tiled_rows_matvec(params.to(device="cpu"), coords.cpu(), procs.cpu(), coords.cpu(),
                              procs.cpu(), V.cpu(), True, 512)
    torch.testing.assert_close(y.cpu(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_pairs_grad_partition_stress(cuda, dtype, tol):
    """The partitioned pairs gradient against its plain version where the
    tile's buckets are one, few or many (``_partition_cases``, up to 100,001
    entries over ten pairs), at half-integer nu and 1.5 -+ ulp: each per-pair
    sum within tol * sum |terms|, bit-equal on a second launch."""
    rng = np.random.default_rng(24)
    for name, nu, ls, idx, h in _partition_cases(rng, dtype, mixed=100_001):
        nu_t, ls_t = (torch.tensor(v, dtype=dtype, device=cuda) for v in (nu, ls))
        idx_t, h_t = (torch.as_tensor(v, dtype=dtype, device=cuda) for v in (idx, h))
        ct = torch.as_tensor(rng.normal(size=h.shape[0]), dtype=dtype, device=cuda)
        args = (nu_t, ls_t, idx_t, h_t, ct)
        got = K.matern_corr_pairs_grad(*args)
        ref = K.matern_corr_pairs_grad_plain(*args)
        mag = K.matern_corr_pairs_grad_plain(*args, absolute=True)
        torch.cuda.synchronize()
        assert got.shape == (len(nu), 2) and torch.isfinite(got).all(), name
        assert bool(((got - ref).abs() <= tol * mag).all()), (name, got, ref, mag)
        assert torch.equal(got, K.matern_corr_pairs_grad(*args)), name


def _matern_stress_blocks(rng, nu, dtype, cuda, ls=800.0):
    """Symmetric distance blocks (zero diagonal) of n in {1, 63, 65, 650},
    all series (x < 2), all CF2 (x >= 2) or mixed: (name, h)."""
    for spread, lo, hi in (("series only", 1e-3, 1.99), ("CF2 only", 2.0, 40.0),
                           ("mixed", 1e-3, 40.0)):
        for n in (1, 63, 65, 650):
            x = rng.uniform(lo, hi, size=(n, n))
            x = np.tril(x, -1) + np.tril(x, -1).T
            yield f"{spread} {n}", torch.as_tensor(x * ls / np.sqrt(2.0 * nu), dtype=dtype,
                                                   device=cuda)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_matern_partition_stress(cuda, dtype, atol):
    """The partitioned block forward against its plain version on blocks
    whose tiles are all series, all CF2 or mixed, n around the 64 x 64 tile
    and a ragged 650 x 411 block, at half-integer nu and 1.5 -+ ulp: the
    symmetric output exactly symmetric and equal bit for bit to the full
    mode's lower triangle, every output bit-equal when rows and columns of h
    are permuted together and without the early CF2 exit."""
    rng = np.random.default_rng(25)
    ls = 800.0
    for nu in _ulp_nus(dtype):
        for name, h in _matern_stress_blocks(rng, nu, dtype, cuda, ls):
            n = h.shape[0]
            full = K.matern_correlation_block(nu, ls, h)
            sym = K.matern_correlation_block(nu, ls, h, symmetric=True)
            ref = K.matern_correlation_block_plain(nu, ls, h)
            torch.cuda.synchronize()
            assert torch.isfinite(full).all() and float((full - ref).abs().max()) <= atol, (nu, name)
            assert torch.equal(sym, sym.T), (nu, name)
            low = torch.tril(torch.ones(n, n, dtype=torch.bool, device=cuda))
            assert torch.equal(sym[low], full[low]), (nu, name)
            perm = torch.randperm(n, device=cuda)
            for s in (False, True):
                moved = K.matern_correlation_block(nu, ls, h[perm][:, perm].contiguous(), symmetric=s)
                assert torch.equal(moved, (sym if s else full)[perm][:, perm]), (nu, name, s)
                assert torch.equal(K.matern_correlation_block(nu, ls, h, symmetric=s, early_exit=False),
                                   sym if s else full), (nu, name, s)
            if n == 650:
                rag = h[:, :411].contiguous()
                got = K.matern_correlation_block(nu, ls, rag)
                assert torch.equal(got, full[:, :411]), (nu, name)
                cols = torch.randperm(411, device=cuda)
                assert torch.equal(K.matern_correlation_block(nu, ls, rag[perm][:, cols].contiguous()),
                                   got[perm][:, cols]), (nu, name)


def test_block_covariance_does_not_synchronize(cuda):
    """``block_covariance`` forward and backward, three blocks with the
    parameters on the card (its ``pair_table`` built inside), under
    ``torch.cuda.set_sync_debug_mode("error")``; value and gradient as on
    the CPU."""
    from cokriging_tpu_torch.cov.matern import block_covariance
    from cokriging_tpu_torch.cov.params import MaternParams

    rng = np.random.default_rng(26)
    c1, c2 = _points(rng, 300, torch.float64, cuda), _points(rng, 211, torch.float64, cuda)
    dists = [[haversine_matrix(c1, c1), haversine_matrix(c1, c2)],
             [None, haversine_matrix(c2, c2)]]
    w = torch.as_tensor(rng.normal(size=(511, 511)), device=cuda)
    x = torch.tensor([1.2, 0.8, 1.4, 1.1, 2.0, 300, 250, 350, 0.04, 0.02, -0.5],
                     dtype=torch.float64, device=cuda)
    flat = x.clone().requires_grad_(True)
    params = MaternParams.from_flat(flat)
    before = K.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cov = block_covariance(params, dists, h_grad=False)
        (g,) = torch.autograd.grad((cov * w).sum(), flat)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = K.launch_counts()
    assert {k: after[k] - before[k] for k in ("matern_correlation", "matern_block_grad")} == {
        "matern_correlation": 3, "matern_block_grad": 3}
    flat_c = x.cpu().requires_grad_(True)
    d_c = [[d.cpu() if d is not None else None for d in row] for row in dists]
    cov_c = block_covariance(MaternParams.from_flat(flat_c), d_c, h_grad=False)
    (g_c,) = torch.autograd.grad((cov_c * w.cpu()).sum(), flat_c)
    torch.testing.assert_close(cov.detach().cpu(), cov_c.detach(), rtol=0.0, atol=1e-12)
    torch.testing.assert_close(g.cpu(), g_c, rtol=1e-9, atol=1e-10)


def test_pair_table_rows_on_card(cuda):
    """``pair_table`` built on the card: each process pair's value and dual
    rows equal ``recurrence_table`` of that pair alone, bit for bit."""
    from cokriging_tpu_torch.cov.matern import _pairs, pair_table
    from cokriging_tpu_torch.cov.params import MaternParams

    params = MaternParams.from_flat(torch.tensor(
        [1.2, 0.8, 1.4, 1.1, 2.0, 300, 250, 350, 0.04, 0.02, -0.5], dtype=torch.float64,
        device=cuda))
    for dtype in (torch.float32, torch.float64):
        table = pair_table(params, cuda, dtype, grad=True)
        for k, (i, j) in enumerate(_pairs(2)):
            assert int(table.index[i, j]) == int(table.index[j, i]) == k
            nu, ls = params.nu[i, j].to(dtype), params.len_scale[i, j].to(dtype)
            assert torch.equal(table.rows(i, j)[0], K.recurrence_table(nu, ls, dtype)[0])
            assert torch.equal(table.rows(i, j)[1], K.recurrence_table(nu, ls, dtype, order=1)[0])


# --- the table-to-map workflow on the card ---------------------------------


def _frame_fields(n, seed):
    """Two processes' long-format frames (three months of n cells, a
    temporal and a lon/lat trend) as a float64 MultiField, all rows main."""
    import pandas as pd

    from cokriging_tpu_torch.fields.field import MultiField

    rng = np.random.default_rng(seed)
    dfs = []
    for name, sign in (("xco2", 1.0), ("sif", -0.7)):
        lat, lon = rng.uniform(30.0, 45.0, n), rng.uniform(-110.0, -90.0, n)
        s = np.sin(np.deg2rad(lat) * 8.0) + 0.5 * np.cos(np.deg2rad(lon) * 6.0)
        dfs.append(pd.concat([
            pd.DataFrame({"time": t, "lat": lat, "lon": lon,
                          name: sign * s + 0.02 * lat + 0.1 * k + rng.normal(scale=0.3, size=n),
                          f"{name}_var": 0.01})
            for k, t in enumerate(pd.date_range("2019-01-01", periods=3, freq="MS"))
        ], ignore_index=True))
    return MultiField.from_dataframes(dfs, ["xco2", "sif"], [["lon", "lat"]] * 2,
                                      "2019-02-01", [0, 0])


_CV_FLAT = [1.0, 0.9, 1.3, 1.2, 1.1, 450.0, 500.0, 550.0, 0.08, 0.1, -0.5]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("kw", [{}, {"materialize_cov": False, "neighbor_method": "device"},
                                {"materialize_cov": False, "neighbor_method": "kd"}])
def test_local_loocv_on_card_matches_cpu(cuda, dtype, tol, kw):
    """Local LOOCV (materialized, direct and kd paths) on the card against
    the same code on the CPU, standardized and on the data scale; the
    materialized path launches the Matern kernel, the direct ones the
    pairs kernel."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.predict.local import LocalPredictor

    mf = _frame_fields(150, 5).astype(dtype)
    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(_CV_FLAT)))
    before = K.launch_counts()
    card = LocalPredictor(mod, mf, device=cuda, **kw)
    got = card.cross_validation(0, max_dist=600.0)
    kernel = "matern_corr_pairs" if kw else "matern_correlation"
    assert K.launch_counts()[kernel] > before[kernel]
    cpu = LocalPredictor(mod, mf, device="cpu", **kw)
    want = cpu.cross_validation(0, max_dist=600.0)
    np.testing.assert_array_equal(got.n_neighbors, want.n_neighbors)
    np.testing.assert_allclose(got.pred, want.pred, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.pred_err, want.pred_err, rtol=tol, atol=tol)
    frame = card.cross_validation(0, max_dist=600.0, postprocess=True)
    np.testing.assert_allclose(frame["residual"], frame["data"] - frame["pred"], rtol=0, atol=0)
    assert np.isfinite(frame["pred"]).all()


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-6, 1e-8)])
def test_iterative_loocv_on_card_matches_dense(cuda, dtype, rtol, atol):
    """CG LOOCV on the card (the pairs kernel in every matvec) against the
    dense LOOCV on the card, a ragged last chunk included."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.predict.iterative import IterativeJointPredictor
    from cokriging_tpu_torch.predict.joint import JointPredictor

    mf = _frame_fields(300, 6).astype(dtype)
    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(_CV_FLAT)))
    before = K.launch_counts()["matern_corr_pairs"]
    ijp = IterativeJointPredictor(mod, mf, block=256, rhs_batch=128, tol=1e-10, maxiter=500,
                                  device=cuda)
    got = ijp.cross_validation(1, postprocess=True)
    assert K.launch_counts()["matern_corr_pairs"] > before
    assert len(ijp.last_diagnostics) == 3
    want = JointPredictor(mod, mf, device=cuda).cross_validation(1, postprocess=True)
    for col in ("data", "pred", "residual", "pred_err"):
        np.testing.assert_allclose(got[col], want[col], rtol=rtol, atol=atol, err_msg=col)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_empirical_variograms_of_a_multifield_on_card(cuda, dtype):
    """``empirical_variograms(mf)`` is ``empirical_variograms_device`` over
    the fields (counts equal, one launch per pass), and its counts are the
    CPU's: equal in float64; in float32 the card's and the host's sin/cos
    round the point features apart in the last ulp, which moves a few pairs
    across an edge (at most 1e-4 of a bin)."""
    mf = _frame_fields(2_000, 7).astype(dtype)
    cfg = E.VarioConfig(max_dist=1500.0, n_bins=15)
    before = K.launch_counts()
    est = E.empirical_variograms(mf, cfg, device=cuda)
    after = K.launch_counts()
    assert (after["variogram_minmax"] - before["variogram_minmax"],
            after["variogram_bin"] - before["variogram_bin"]) == (1, 1)
    _, centers, means, counts = E.empirical_variograms_device(
        [f.coords for f in mf.fields], [f.values for f in mf.fields], cfg, device=cuda)
    np.testing.assert_array_equal(est.bin_counts, counts)
    np.testing.assert_array_equal(est.bin_means, means)
    cpu = E.empirical_variograms(mf, cfg, device="cpu")
    if dtype == torch.float64:
        np.testing.assert_array_equal(est.bin_counts, cpu.bin_counts)
    else:
        np.testing.assert_allclose(est.bin_counts, cpu.bin_counts, rtol=1e-4, atol=0)
    assert est.timestamp == "2019-02-01" and est.config.n_procs == 2


def test_cli_round_trip_on_card_matches_cpu(cuda, tmp_path):
    """``python -m cokriging_tpu_torch fit / predict / loocv --device cuda``
    against the same commands with ``--device cpu``, in float64: parameters
    rtol 1e-6, predictions and LOOCV columns atol 1e-6."""
    import pandas as pd

    from cokriging_tpu_torch.__main__ import main
    from cokriging_tpu_torch.data.grids import main_coords_array
    from cokriging_tpu_torch.utils.io import load_params, load_table, save_table

    mc = main_coords_array()
    rng = np.random.default_rng(6)
    paths = []
    for k, name in enumerate(["xco2", "sif"]):
        base = (np.sin(np.deg2rad(mc[:, 0]) * 5) + 0.5 * np.cos(np.deg2rad(mc[:, 1]) * (3 + k))
                + 0.6 * np.random.default_rng(600 + k).normal(size=len(mc)))
        df = pd.concat([pd.DataFrame({"time": pd.Timestamp(t), "lat": mc[:, 0], "lon": mc[:, 1],
                                      name: base + 0.15 * rng.normal(size=len(mc)) + 0.05 * j,
                                      f"{name}_var": 0.01})
                        for j, t in enumerate(["2018-04-01", "2018-05-01", "2018-06-01"])],
                       ignore_index=True)
        paths.append(str(tmp_path / f"{name}.parquet"))
        save_table(paths[-1], df)
    common = ["--data", *paths, "--timestamp", "2018-05-01", "--timedeltas", "0", "0"]
    out = {}
    for dev in ("cuda", "cpu"):
        p = str(tmp_path / f"p_{dev}.npz")
        main(["fit", *common, "--max-dist", "3000", "--n-bins", "8", "--maxiter", "60",
              "--project-validity", "--device", dev, "--out", p])
        out[dev, "params"] = load_params(p).to_flat().numpy()
        main(["predict", *common, "--params", p, "--max-dist", "2000", "--device", dev,
              "--out", str(tmp_path / f"pred_{dev}.parquet")])
        out[dev, "pred"] = load_table(tmp_path / f"pred_{dev}.parquet")
        main(["loocv", *common, "--params", p, "--max-dist", "3000", "--device", dev,
              "--out", str(tmp_path / f"cv_{dev}.parquet")])
        out[dev, "cv"] = load_table(tmp_path / f"cv_{dev}.parquet")
    np.testing.assert_allclose(out["cuda", "params"], out["cpu", "params"], rtol=1e-6)
    for key, cols in (("pred", ("pred", "pred_err")),
                      ("cv", ("data", "pred", "residual", "pred_err"))):
        for col in cols:
            np.testing.assert_allclose(out["cuda", key][col], out["cpu", key][col], atol=1e-6,
                                       err_msg=f"{key} {col}")


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("geodesic,covariogram,n_rep,n_bins", [
    (True, False, 5, 15), (True, True, 70, 9), (False, False, 130, 30),
])
def test_variogram_bin_batch_matches_plain_and_single_launches(cuda, dtype, rtol, geodesic,
                                                               covariogram, n_rep, n_bins):
    """The replicate-batched bin pass over three variograms (ragged strips,
    one or three replicate groups, one or two windows): counts equal to the
    plain version's and to each replicate's own pass, sums within rtol of
    both; one launch per window."""
    rng = np.random.default_rng(11)
    np_dt = np.dtype(str(dtype).replace("torch.", ""))
    pts = [_points(rng, n, dtype, cuda) for n in (130, 67)]
    if not geodesic:
        pts = [p / 10.0 for p in pts]
    feats = [E.point_features(p, geodesic) for p in pts]
    vals = [torch.as_tensor(rng.normal(size=(n_rep, p.shape[0])), dtype=dtype, device=cuda)
            for p in pts]
    pairs = ((0, 0), (0, 1), (1, 1))
    max_d = 2000.0 if geodesic else 3.0
    h_max = float(E._h_of_d(np_dt.type(max_d), geodesic))
    h_snap = float(E._h_of_d(np_dt.type(1e-6), geodesic))
    mm = K.variogram_minmax_pairs([(feats[i], feats[j], i == j) for i, j in pairs], geodesic,
                                  h_max, h_snap).cpu().numpy()
    edges = [E._device_bins(lo, hi, geodesic, np_dt.type(1e-6), n_bins, np_dt)[1] for lo, hi in mm]
    sides = [(feats[i], feats[j], vals[i], vals[j], i == j) for i, j in pairs]
    before = K.launch_counts()["variogram_bin_batch"]
    s_k, n_k = K.variogram_bin_batch(sides, edges, geodesic, covariogram, h_max)
    assert K.launch_counts()["variogram_bin_batch"] == before + (2 if n_bins > 24 else 1)
    s_p, n_p = K.variogram_bin_batch_plain(sides, edges, geodesic, covariogram, h_max)
    assert s_k.shape == (3, n_rep, n_bins) and torch.equal(n_k, n_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k, s_p, rtol=rtol, atol=1e-12)
    for b in (0, n_rep - 1):
        one = [(fa, fb, va[b].contiguous(), vb[b].contiguous(), m) for fa, fb, va, vb, m in sides]
        s1, n1 = K.variogram_bin_pairs(one, edges, geodesic, covariogram, h_max)
        assert torch.equal(n1, n_k)
        torch.testing.assert_close(s_k[:, b], s1, rtol=rtol, atol=1e-12)


def _partial_scales(nu, ls, h):
    """Per field of the tangent's partials the size of its rounding error:
    1 for M (at most 1), and for dM/dnu = M dlp/dnu + e^lp (dK/dnu + dK/dx
    da/dnu) and dM/dls = -M nu/ls + e^lp dK/dx da/dls the largest sum over
    the block of the absolute values of the parts each adds up (from the
    plain K_nu and its partials), as the kernels' sums are held to their
    sums of |terms|: dM/dnu cancels, so its own largest entry is no scale of
    its error."""
    from cokriging_tpu_torch.kernels.bessel import _kv_value

    nu = torch.as_tensor(nu, dtype=torch.float64, device=h.device)
    ls = torch.as_tensor(ls, dtype=torch.float64, device=h.device)
    hc = h.double().abs()
    pos = hc > 0.0
    a = torch.sqrt(2.0 * nu) * torch.where(pos, hc, 1.0) / ls
    k, dk_dnu, dk_dx = _kv_value(nu, a, True)
    e = torch.exp((1.0 - nu) * math.log(2.0) - torch.lgamma(nu) + nu * torch.log(a))
    m = e * k
    dlp = -math.log(2.0) - torch.digamma(nu) + torch.log(a) + 0.5
    s_nu = (m * dlp).abs() + (e * dk_dnu).abs() + (e * dk_dx * a / (2.0 * nu)).abs()
    s_ls = (m * nu / ls).abs() + (e * dk_dx * a / ls).abs()
    return [1.0] + [float(t[pos & torch.isfinite(t)].max()) for t in (s_nu, s_ls)]


# tolerances of the second-order kernels against their plain versions: the
# tangent per entry relative to the largest |entry| (float32: the first-order
# partials' own rounding, as the block gradient's 1e-5), and its partials
# per field relative to ``_partial_scales``; the Hessian sums
# within tol (first-order sums) and tol2 (second-order sums) of their sums
# of |terms|, about ten times the largest reading on an H100 at these cases
# (float32 1.3e-7 / 5.4e-7, float64 1.6e-16 / 1.0e-15)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("nu,ls", [(0.3, 300.0), (0.5, 300.0), (1.5, 800.0), (2.7, 1500.0)])
def test_block_tangent_kernel_matches_plain(cuda, dtype, tol, nu, ls):
    """The block tangent's two kernels against their plain versions: the
    partials (one launch) field by field (within tol of ``_partial_scales``),
    and the combine of them (one launch) against the plain tangent over the
    plain partials; a ragged full block with exact zeros and a symmetric
    block (whose partials and tangent are exactly symmetric and equal the
    full evaluation). The combine's 16-byte pass and its one-entry pass
    (partials not 16-byte aligned) give the same bits, and it takes its
    scale and weights as host values as well."""
    rng = np.random.default_rng(41)
    a = _points(rng, 300, dtype, cuda)
    b = torch.cat([a[:7], _points(rng, 210, dtype, cuda)])
    w = torch.tensor([0.7, -1.3, 0.4, 2.1e-3], dtype=torch.float64, device=cuda)
    scale = torch.tensor(1.7, dtype=torch.float64, device=cuda)
    names = ("matern_block_partials", "matern_block_tangent")
    for hh, sym in ((haversine_matrix(a, b), False), (haversine_matrix(a, a), True)):
        before = K.launch_counts()
        parts = K.matern_block_partials(nu, ls, hh, symmetric=sym)
        got = K.matern_block_tangent(scale, w, parts)
        torch.cuda.synchronize()
        assert {k: K.launch_counts()[k] - before[k] for k in names} == dict.fromkeys(names, 1)
        plain = K.matern_block_partials_plain(nu, ls, hh, symmetric=sym)
        assert parts.shape == plain.shape and parts.dtype == dtype
        assert torch.isfinite(parts).all()
        scales = _partial_scales(nu, ls, hh)
        for k in range(3):
            assert float((parts[k] - plain[k]).abs().max()) <= tol * scales[k], k
        ref = K.matern_block_tangent_plain(scale, w, plain)
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
        n, m = hh.shape
        odd = torch.empty(3 * n * m + 1, dtype=dtype, device=cuda)[1:].view(3, n, m)
        odd.copy_(parts)
        assert torch.equal(K.matern_block_tangent(scale, w, odd), got)
        assert torch.equal(K.matern_block_tangent(1.7, w.tolist(), parts), got)
        if sym:
            assert torch.equal(parts, parts.transpose(1, 2)) and torch.equal(got, got.T)
            full = K.matern_block_partials(nu, ls, hh)
            for k in range(3):
                assert float((parts[k] - full[k]).abs().max()) <= tol * scales[k], k


@pytest.mark.parametrize("dtype,tol,tol2", [(torch.float32, 1e-6, 5e-6),
                                             (torch.float64, 1e-14, 1e-14)])
@pytest.mark.parametrize("nu,ls", [(0.3, 300.0), (0.5, 300.0), (1.5, 800.0), (2.7, 1500.0)])
def test_block_hess_kernel_matches_plain(cuda, dtype, tol, tol2, nu, ls):
    """The five second-order sums against the plain version, the first two
    within tol and the three second-order ones within tol2 of their sums of
    |terms|: a ragged full block with exact zeros read through a row stride,
    and a symmetric block with an asymmetric cotangent, which also equals
    the full evaluation and repeats bit for bit."""
    rng = np.random.default_rng(42)
    a = _points(rng, 300, dtype, cuda)
    b = torch.cat([a[:7], _points(rng, 210, dtype, cuda)])
    wide = haversine_matrix(a, torch.cat([b, b]))
    h = wide[:, :217]
    hs = haversine_matrix(a, a)
    bar = torch.tensor([tol, tol, tol2, tol2, tol2], dtype=torch.float64, device=cuda)
    for hh, sym in ((h, False), (hs, True)):
        ct = torch.as_tensor(rng.normal(size=tuple(hh.shape)), dtype=dtype, device=cuda)
        before = K.launch_counts()["matern_block_hess"]
        got = K.matern_block_hess(nu, ls, hh, ct, symmetric=sym)
        torch.cuda.synchronize()
        assert K.launch_counts()["matern_block_hess"] == before + 1
        ref, mag = K.matern_block_hess_plain(nu, ls, hh, ct, symmetric=sym, magnitude=True)
        assert got.dtype == torch.float64 and torch.isfinite(got).all()
        assert bool(((got - ref).abs() <= bar * mag).all()), (got, ref, mag)
        if sym:
            full = K.matern_block_hess(nu, ls, hh, ct)
            assert bool(((got - full).abs() <= bar * mag).all()), (got, full, mag)
            assert torch.equal(got, K.matern_block_hess(nu, ls, hh, ct, symmetric=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geodesic,covariogram", [(True, False), (False, True)])
@pytest.mark.parametrize("n_rep", [1, 63, 64, 65, 200])
def test_variogram_bin_batch_replicate_groups_and_windows(cuda, dtype, geodesic, covariogram,
                                                          n_rep):
    """The batched bin pass at ragged strips (130 and 67 points), at 1, 63,
    64, 65 and 200 replicates (one to four groups of 64, full and ragged)
    and 40 bins (two windows, two launches): counts equal to the plain
    version's, sums within rtol 1e-5 / 1e-12 of it, and two runs bit-equal."""
    rng = np.random.default_rng(12)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    np_dt = np.dtype(str(dtype).replace("torch.", ""))
    pts = [_points(rng, n, dtype, cuda) for n in (130, 67)]
    if not geodesic:
        pts = [p / 10.0 for p in pts]
    feats = [E.point_features(p, geodesic) for p in pts]
    vals = [torch.as_tensor(rng.normal(size=(n_rep, p.shape[0])), dtype=dtype, device=cuda)
            for p in pts]
    pairs = ((0, 0), (0, 1), (1, 1))
    max_d = 2000.0 if geodesic else 3.0
    h_max = float(E._h_of_d(np_dt.type(max_d), geodesic))
    h_snap = float(E._h_of_d(np_dt.type(1e-6), geodesic))
    mm = K.variogram_minmax_pairs([(feats[i], feats[j], i == j) for i, j in pairs], geodesic,
                                  h_max, h_snap).cpu().numpy()
    edges = [E._device_bins(lo, hi, geodesic, np_dt.type(1e-6), 40, np_dt)[1] for lo, hi in mm]
    sides = [(feats[i], feats[j], vals[i], vals[j], i == j) for i, j in pairs]
    before = K.launch_counts()["variogram_bin_batch"]
    s_k, n_k = K.variogram_bin_batch(sides, edges, geodesic, covariogram, h_max)
    assert K.launch_counts()["variogram_bin_batch"] == before + 2
    s_2, n_2 = K.variogram_bin_batch(sides, edges, geodesic, covariogram, h_max)
    s_p, n_p = K.variogram_bin_batch_plain(sides, edges, geodesic, covariogram, h_max)
    torch.cuda.synchronize()
    assert s_k.shape == (3, n_rep, 40) and torch.equal(n_k, n_p) and int(n_k.sum()) > 0
    assert torch.equal(s_k, s_2) and torch.equal(n_k, n_2)
    torch.testing.assert_close(s_k, s_p, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_variogram_bin_batch_rounds_and_replicate_prefix(cuda, dtype):
    """The batched bin pass where its strips take several rounds (a
    marginal variogram of 12,000 points, ~17,800 chunks, with its cross
    variogram against 3,000 points): counts equal to the plain version's and
    sums within rtol 1e-5 / 1e-12 of it at 3 replicates; at 70 replicates
    (two groups of 64) the first 3 replicates' sums are those of the
    3-replicate call bit for bit, since the order of a replicate's sums
    depends on the strips' shapes only."""
    rng = np.random.default_rng(13)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    np_dt = np.dtype(str(dtype).replace("torch.", ""))
    pts = [_points(rng, n, dtype, cuda) / 10.0 for n in (12_000, 3_000)]
    feats = [E.point_features(p, False) for p in pts]
    vals = [torch.as_tensor(rng.normal(size=(70, p.shape[0])), dtype=dtype, device=cuda)
            for p in pts]
    pairs = ((0, 0), (0, 1))
    h_max = float(E._h_of_d(np_dt.type(1.5), False))
    h_snap = float(E._h_of_d(np_dt.type(1e-6), False))
    mm = K.variogram_minmax_pairs([(feats[i], feats[j], i == j) for i, j in pairs], False,
                                  h_max, h_snap).cpu().numpy()
    edges = [E._device_bins(lo, hi, False, np_dt.type(1e-6), 12, np_dt)[1] for lo, hi in mm]

    def sides(b):
        return [(feats[i], feats[j], vals[i][:b], vals[j][:b], i == j) for i, j in pairs]

    s_3, n_3 = K.variogram_bin_batch(sides(3), edges, False, False, h_max)
    s_70, n_70 = K.variogram_bin_batch(sides(70), edges, False, False, h_max)
    s_p, n_p = K.variogram_bin_batch_plain(sides(3), edges, False, False, h_max)
    torch.cuda.synchronize()
    assert torch.equal(n_3, n_p) and torch.equal(n_70, n_p) and int(n_p.sum()) > 0
    torch.testing.assert_close(s_3, s_p, rtol=rtol, atol=1e-12)
    assert torch.equal(s_70[:, :3], s_3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", [1.37, "1.5-ulp", 1.5, 0.2])
def test_block_hess_sums_with_and_without_a_prebuilt_row_bit_equal(cuda, dtype, nu):
    """The Hessian sums with the pair's second-order row built beforehand
    (``recurrence_table(..., order=2)[0]``, as the live path hands it in)
    equal the sums that build it in the call, bit for bit: a symmetric and
    a ragged full block with exact zeros."""
    np_dt = np.dtype(str(dtype).replace("torch.", ""))
    if nu == "1.5-ulp":
        nu = float(np.nextafter(np_dt.type(1.5), np_dt.type(0)))
    rng = np.random.default_rng(44)
    a = _points(rng, 300, dtype, cuda)
    b = torch.cat([a[:7], _points(rng, 210, dtype, cuda)])
    row = K.recurrence_table(torch.tensor(nu, dtype=dtype, device=cuda),
                             torch.tensor(800.0, dtype=dtype, device=cuda), dtype, order=2)[0]
    for hh, sym in ((haversine_matrix(a, a), True), (haversine_matrix(a, b), False)):
        ct = torch.as_tensor(rng.normal(size=tuple(hh.shape)), dtype=dtype, device=cuda)
        got = K.matern_block_hess(nu, 800.0, hh, ct, symmetric=sym, table=row)
        want = K.matern_block_hess(nu, 800.0, hh, ct, symmetric=sym)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, want)


def test_one_second_order_row_build_per_hessian(cuda):
    """A Hessian of the NLL through the block kernels (float64, 2 x 40
    points, ``torch.autograd.functional.hessian``) builds the second-order
    rows once, for every process pair together, and launches the Hessian
    sums once per block (3)."""
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.estimate.nll import joint_distance_blocks, neg_log_likelihood

    rng = np.random.default_rng(45)
    d = joint_distance_blocks([_points(rng, 40, torch.float64, cuda) for _ in range(2)])
    z = torch.as_tensor(rng.normal(size=80), device=cuda)
    spec = MaternParams.default(2).spec
    x = torch.tensor([1.2, 0.8, 1.4, 1.1, 2.0, 300, 250, 350, 0.04, 0.02, -0.5],
                     dtype=torch.float64, device=cuda)
    before = K.launch_counts()
    hess = torch.autograd.functional.hessian(
        lambda f: neg_log_likelihood(f, d, z, spec, analytic_grad=False), x)
    torch.cuda.synchronize()
    grew = {k: K.launch_counts()[k] - before[k] for k in
            ("recurrence_table_order2", "matern_block_hess")}
    assert grew == {"recurrence_table_order2": 1, "matern_block_hess": 3}
    assert torch.isfinite(hess).all()


def test_block_hessian_on_card_matches_cpu_without_synchronizing(cuda):
    """The NLL's Hessian through the block kernels (float64, 2 x 40 points)
    equals the CPU's elementwise one, its backward passes run under
    ``torch.cuda.set_sync_debug_mode("error")``, a first-order gradient
    launches only the block-gradient kernel, once per block, and the
    Hessian's 11 rows build the tangent's partials once per block (3) and
    combine them once per row and block (33)."""
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.estimate.nll import joint_distance_blocks, neg_log_likelihood

    rng = np.random.default_rng(43)
    coords = [_points(rng, 40, torch.float64, cuda) for _ in range(2)]
    z = torch.as_tensor(rng.normal(size=80), device=cuda)
    spec = MaternParams.default(2).spec
    x = torch.tensor([1.2, 0.8, 1.4, 1.1, 2.0, 300, 250, 350, 0.04, 0.02, -0.5],
                     dtype=torch.float64)
    out = {}
    for dev in ("cuda", "cpu"):
        d = joint_distance_blocks([c.to(dev) for c in coords])

        def fn(flat):
            return neg_log_likelihood(flat, d, z.to(dev), spec, analytic_grad=False)

        flat = x.to(dev).requires_grad_(True)
        before = K.launch_counts()
        (g,) = torch.autograd.grad(fn(flat), flat)
        names = ("matern_block_grad", "matern_block_partials", "matern_block_tangent",
                 "matern_block_hess")
        grew = {k: K.launch_counts()[k] - before[k] for k in names}
        assert grew == ({"matern_block_grad": 3, "matern_block_partials": 0,
                         "matern_block_tangent": 0, "matern_block_hess": 0}
                        if dev == "cuda" else dict.fromkeys(grew, 0))
        flat = x.to(dev).requires_grad_(True)
        value = fn(flat)
        (g1,) = torch.autograd.grad(value, flat, create_graph=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        before = K.launch_counts()
        try:
            rows = [torch.autograd.grad(g1[k], flat, retain_graph=True)[0] for k in range(11)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # the tangent's partials once per block, one combine per row and block
        grew = {k: K.launch_counts()[k] - before[k] for k in names[1:3]}
        assert grew == ({"matern_block_partials": 3, "matern_block_tangent": 33}
                        if dev == "cuda" else dict.fromkeys(grew, 0))
        out[dev] = torch.stack(rows).cpu()
    hc, hp = out["cuda"], out["cpu"]
    assert float((hc - hp).abs().max()) <= 1e-9 * float(hp.abs().max())


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_registered_pairs_op_matches_plain(cuda, dtype, atol):
    """``torch.ops.cokriging_tpu_torch.matern_corr_pairs`` on CUDA tensors
    is the kernel (one launch, counted), equal to the plain version within
    the forward's bar; on their CPU copies it is the plain version."""
    rng = np.random.default_rng(19)
    (nu, ls), t = _pairs_case(rng, 3, dtype, cuda)
    nu, ls = nu.to(cuda), ls.to(cuda)
    before = K.launch_counts()["matern_corr_pairs"]
    got = torch.ops.cokriging_tpu_torch.matern_corr_pairs(nu, ls, t["idx"], t["h"], None, True)
    torch.cuda.synchronize()
    assert K.launch_counts()["matern_corr_pairs"] == before + 1
    ref = K.matern_corr_pairs_plain(nu, ls, t["idx"], t["h"])
    torch.testing.assert_close(got, ref, rtol=0.0, atol=atol)
    host = torch.ops.cokriging_tpu_torch.matern_corr_pairs(
        nu.cpu(), ls.cpu(), t["idx"].cpu(), t["h"].cpu(), None, True)
    assert torch.equal(host, K.matern_corr_pairs_plain(nu.cpu(), ls.cpu(), t["idx"].cpu(),
                                                       t["h"].cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_served_artifact_on_card_matches_live_predictor(cuda, dtype):
    """A local predictor's direct-assembly forward exported on the card
    (``utils.export``), saved and loaded, equals the live predictor bit for
    bit, and its calls launch the pairs kernel through the registered op."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.predict.local import LocalPredictor
    from cokriging_tpu_torch.utils.export import export_local_prediction, load_program
    from cokriging_tpu_torch.utils.export import make_local_prediction_fn

    mf = _frame_fields(150, 5).astype(dtype)
    mod = MultivariateMatern(params=MaternParams.from_flat(torch.tensor(_CV_FLAT)))
    lp = LocalPredictor(mod, mf, device=cuda, materialize_cov=False, neighbor_method="device")
    rng = np.random.default_rng(2)
    pc = np.column_stack([rng.uniform(31.0, 44.0, 64), rng.uniform(-109.0, -91.0, 64)])
    fn = load_program(export_local_prediction(lp, 0, pc, max_dist=600.0, platforms=["cuda"]))
    _, args = make_local_prediction_fn(lp, 0, pc, max_dist=600.0)
    before = K.launch_counts()["matern_corr_pairs"]
    got = fn(*args)
    torch.cuda.synchronize()
    assert K.launch_counts()["matern_corr_pairs"] > before
    live = lp(0, pc.astype(np.dtype(str(dtype).replace("torch.", ""))), max_dist=600.0)
    for g, w in zip(got, (live.pred, live.pred_err, live.n_neighbors)):
        np.testing.assert_array_equal(g.cpu().numpy(), w)
    assert np.isfinite(live.pred).all()
