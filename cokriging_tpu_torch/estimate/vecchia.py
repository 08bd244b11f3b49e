"""Vecchia approximation of the multivariate Gaussian NLL.

Counterpart of ``cokriging_tpu/estimate/vecchia.py``. The exact likelihood
(``estimate.nll``) factorizes the joint density with one N x N Cholesky;
the Vecchia approximation (Vecchia 1988; Katzfuss & Guinness 2021) replaces
each conditional of

    p(z) = prod_i p(z_i | z_1, ..., z_{i-1})

by conditioning on the m nearest previous observations in a maxmin
ordering, so every term is one (m+1) x (m+1) Cholesky: O(N m^3) operations
and O(N m) memory. With m = N - 1 the product is exact for any ordering.
All p processes are stacked and ordered jointly; a conditioning set may mix
processes, with the reference's conventions (nugget on exact-zero marginal
distances, rho sigma_a sigma_b across; src/model.py:193-207).

- ordering: exact maxmin on the device (N sequential steps, first-index
  argmax ties) up to 20,000 points, above that ``coarse_to_fine_order``
  (host numpy, O(N log N));
- neighbors: blocked masked top-k on the device up to 20,000 points, above
  that doubling-block kd-trees on the host (``nearest_previous_neighbors_kd``);
- the NLL runs over fixed-size chunks of terms; each chunk gathers only the
  lower triangle of its symmetric (m+1)-wide windows
  (``cov.matern.windows_covariance``, on the card the gathered-pairs kernels)
  and reads the conditional off the last component of u = L^-1 z (for the
  window [neighbors, self], -2 log p(z_i | nbrs) = u_m^2 + 2 log L_mm +
  log 2 pi); absent neighbors are identity lanes with z = 0.

The reference bounds reverse-mode memory with ``jax.checkpoint`` over its
chunk scan; here ``_WindowsNllSum`` takes value and gradient chunk by chunk
(one ``autograd.grad`` per chunk, summed), which bounds memory the same way.
Every evaluation runs in the windows' dtype.
"""

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import pair_table, windows_covariance
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate.nll import _bounds, _value_and_grad, sigmoid_box_lbfgs
from cokriging_tpu_torch.estimate.wls import _box_forward
from cokriging_tpu_torch.kernels.distance import distance_matrix
from cokriging_tpu_torch.utils.config import resolve_device

#: Data size above which "auto" picks the coarse ordering and kd neighbors.
AUTO_THRESHOLD = 20_000
#: Value of one term at a non-PD window (its gradient there is zero).
_BAD_TERM = 2e6

# ---------------------------------------------------------------------------
# orderings
# ---------------------------------------------------------------------------


def maxmin_order(coords, geodesic: bool = True, device=None) -> np.ndarray:
    """Maxmin (farthest-point) permutation: start nearest the centroid, then
    repeatedly pick the point farthest from all picked points (first index
    on ties), on ``device`` (the card unless ``device="cpu"``). The standard
    Vecchia ordering (Guinness 2018). Exact but sequential: N steps of O(N)
    work; for large N use ``coarse_to_fine_order``."""
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(coords), device=dev)
    n = c.shape[0]
    centroid = c.mean(dim=0, keepdim=True)
    prev = torch.argmin(distance_matrix(centroid, c, geodesic)[0]).reshape(1)
    picked = [prev]
    mindist = torch.full((n,), math.inf, dtype=c.dtype, device=dev)
    mindist.index_fill_(0, prev, -math.inf)
    for _ in range(1, n):
        drow = distance_matrix(c.index_select(0, prev), c, geodesic)[0]
        mindist = torch.minimum(mindist, drow)
        prev = torch.argmax(mindist).reshape(1)
        mindist.index_fill_(0, prev, -math.inf)  # never picked again
        picked.append(prev)
    return torch.cat(picked).cpu().numpy()


def _sphere_embed(coords):
    """[lat, lon] degrees -> 3-D unit-sphere points. Chordal distance is
    monotone in great-circle distance, so nearest-neighbor sets under the
    Euclidean kd-tree metric match the haversine ones."""
    c = np.asarray(coords, np.float64)
    lat = np.deg2rad(c[:, 0])
    lon = np.deg2rad(c[:, 1])
    cl = np.cos(lat)
    return np.column_stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)])


def coarse_to_fine_order(coords, geodesic: bool = True, seed: int = 0) -> np.ndarray:
    """Approximate maxmin permutation by nested-grid decimation, O(N log N),
    on the host (the reference's algorithm and random stream, copied).

    Level l hashes points to a grid of cell size domain / 2^l and appends
    one random representative per newly resolved cell, shuffled within the
    level; exact-duplicate coordinates, which no refinement separates, are
    appended shuffled at the end.
    """
    pts = _sphere_embed(coords) if geodesic else np.asarray(coords, np.float64)
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    lo = pts.min(axis=0)
    span = float((pts.max(axis=0) - lo).max()) or 1.0
    centroid = pts.mean(axis=0)
    first = int(np.argmin(((pts - centroid) ** 2).sum(axis=1)))
    remaining = np.ones(n, bool)
    remaining[first] = False
    chunks = [np.array([first], np.int64)]
    for level in range(31):
        if not remaining.any():
            break
        cells = np.floor((pts - lo) / span * (1 << level)).astype(np.int64)
        key = cells[:, 0]
        for d in range(1, cells.shape[1]):
            key = key * 2097169 + cells[:, d]  # prime-mixed row hash
        # cells already holding a picked point are covered at this level
        covered = np.unique(key[~remaining])
        idx = np.flatnonzero(remaining)
        kr = key[idx]
        open_cell = ~np.isin(kr, covered)
        idx, kr = idx[open_cell], kr[open_cell]
        if idx.size:
            order = np.lexsort((rng.random(idx.size), kr))
            ko = kr[order]
            first_in_cell = np.ones(order.size, bool)
            first_in_cell[1:] = ko[1:] != ko[:-1]
            picked = idx[order[first_in_cell]]
            rng.shuffle(picked)
            chunks.append(picked)
            remaining[picked] = False
    if remaining.any():  # exact-duplicate coordinates
        dup = np.flatnonzero(remaining)
        rng.shuffle(dup)
        chunks.append(dup)
    out = np.concatenate(chunks)
    assert out.size == n
    return out


# ---------------------------------------------------------------------------
# nearest previous neighbors under an ordering
# ---------------------------------------------------------------------------


def nearest_previous_neighbors(
    coords_ord, m: int, geodesic: bool = True, block: int = 512, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """(n, m) indices of each point's m nearest predecessors in the ordering
    and a validity mask (early points have fewer than m): exact blocked
    masked top-k on ``device``, O(N^2 / block) passes. The order of equal
    distances within a row may differ from the reference's ``lax.top_k``; a
    Vecchia term depends only on the set."""
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(coords_ord), device=dev)
    n = c.shape[0]
    cols = torch.arange(n, device=dev)[None, :]
    idxs, masks = [], []
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(n, r0 + block), device=dev)[:, None]
        d = distance_matrix(c[r0:r0 + block], c, geodesic)
        score = torch.where(cols < rows, d, math.inf)  # strictly previous
        neg, idx = torch.topk(-score, m, dim=1)
        idxs.append(idx.int())
        masks.append(torch.isfinite(neg))
    return torch.cat(idxs).cpu().numpy(), torch.cat(masks).cpu().numpy()


def nearest_previous_neighbors_kd(
    coords_ord, m: int, geodesic: bool = True, exact_prefix: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """kd-tree nearest-previous-neighbor search, O(N log N) on the host (the
    reference's algorithm, copied).

    The first ``exact_prefix`` rows take an exact brute-force search. Later
    rows go in doubling blocks [B, 2B): a kd-tree over the prefix [0, B)
    serves the m nearest prefix points, and a global query (m + 1 nearest,
    filtered to index < row) recovers close same-block predecessors; the
    merged candidates' m closest win. Same-block predecessors beyond the
    global m + 1 nearest can be missed: a conditioning-set approximation
    (any predecessor subset gives a valid Vecchia likelihood).
    """
    from scipy.spatial import cKDTree

    coords_ord = np.asarray(coords_ord)
    n = coords_ord.shape[0]
    pts = _sphere_embed(coords_ord) if geodesic else np.asarray(coords_ord, np.float64)
    nbr = np.zeros((n, m), np.int32)
    mask = np.zeros((n, m), bool)

    p = min(n, max(exact_prefix, m + 1))
    for i in range(1, p):
        d2 = ((pts[:i] - pts[i]) ** 2).sum(axis=1)
        k = min(i, m)
        best = np.argpartition(d2, k - 1)[:k] if k < i else np.arange(i)
        best = best[np.argsort(d2[best], kind="stable")]
        nbr[i, :k] = best
        mask[i, :k] = True
    if p >= n:
        return nbr, mask

    tree_all = cKDTree(pts)
    b = p
    while b < n:
        hi = min(n, 2 * b)
        rows = np.arange(b, hi)
        tree_b = cKDTree(pts[:b])
        k_b = min(m, b)
        _, ii_b = tree_b.query(pts[rows], k=k_b, workers=-1)
        ii_b = ii_b.reshape(rows.size, k_b)
        _, ii_g = tree_all.query(pts[rows], k=m + 1, workers=-1)
        ii_g = ii_g.reshape(rows.size, m + 1)
        cand = np.concatenate([ii_b, ii_g], axis=1)
        valid = cand < rows[:, None]
        d2 = ((pts[cand] - pts[rows][:, None, :]) ** 2).sum(axis=-1)
        d2 = np.where(valid, d2, np.inf)
        # drop duplicate candidates (global hits already in the prefix set)
        o = np.argsort(cand, axis=1, kind="stable")
        c_sorted = np.take_along_axis(cand, o, axis=1)
        dup_sorted = np.zeros_like(valid)
        dup_sorted[:, 1:] = c_sorted[:, 1:] == c_sorted[:, :-1]
        dup = np.zeros_like(valid)
        np.put_along_axis(dup, o, dup_sorted, axis=1)
        d2 = np.where(dup, np.inf, d2)
        sel = np.argsort(d2, axis=1, kind="stable")[:, :m]
        nbr_rows = np.take_along_axis(cand, sel, axis=1)
        msk = np.isfinite(np.take_along_axis(d2, sel, axis=1))
        nbr[rows] = np.where(msk, nbr_rows, 0).astype(np.int32)
        mask[rows] = msk
        b = hi
    return nbr, mask


# ---------------------------------------------------------------------------
# the Vecchia NLL
# ---------------------------------------------------------------------------


def _term_windows(coords_ord, values_ord, procs_ord, mvar_ord, nbr, nbr_mask, device):
    """The per-term (m+1)-wide windows [neighbors..., self], gathered on the
    host and moved to ``device`` once: (coords (n, m+1, 2), z (n, m+1),
    procs (n, m+1), measurement variances (n, m+1), mask (n, m+1))."""
    values_ord = np.asarray(values_ord)
    nbr = np.asarray(nbr)
    n = nbr.shape[0]
    idx = np.concatenate([nbr, np.arange(n, dtype=nbr.dtype)[:, None]], axis=1)
    mask = np.concatenate([np.asarray(nbr_mask), np.ones((n, 1), bool)], axis=1)
    win_z = np.where(mask, values_ord[idx], 0.0).astype(values_ord.dtype)
    if mvar_ord is None:
        mvar_ord = np.zeros(n, values_ord.dtype)
    arrays = (np.asarray(coords_ord)[idx], win_z, np.asarray(procs_ord)[idx],
              np.asarray(mvar_ord)[idx], mask)
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _chunk_nll(flat, spec, win, geodesic, table=None):
    """Sum of -2 log p(z_i | nbrs) over one chunk of terms, batched over the
    chunk. A window that does not factorize (found on a no-grad
    ``cholesky_ex`` probe) is replaced by the identity before the
    differentiable factorization, so no failed factor enters autograd, and
    its term is the penalty 2e6 with an exactly zero gradient. ``table``:
    the ``pair_table`` of ``flat``'s values, or None to build it."""
    params = MaternParams.from_flat(flat, spec=spec)
    coords, z, procs, mvar, mask = win
    m1 = z.shape[-1]
    d = distance_matrix(coords, coords, geodesic)
    cov = windows_covariance(params, d, procs, mvar, table=table)
    m2 = mask[..., :, None] & mask[..., None, :]
    eye = torch.eye(m1, dtype=cov.dtype, device=cov.device)
    cov = torch.where(m2, cov, eye)
    with torch.no_grad():
        probe, info = torch.linalg.cholesky_ex(cov)
        bad = (info != 0) | torch.isnan(probe).any(dim=(-2, -1))
    chol, _ = torch.linalg.cholesky_ex(torch.where(bad[..., None, None], eye, cov))
    u = torch.linalg.solve_triangular(chol, z[..., None], upper=False)[..., 0]
    ll = u[..., -1] ** 2 + 2.0 * torch.log(chol[..., -1, -1])
    return torch.where(bad, _BAD_TERM, ll).sum()


class _WindowsNllSum(torch.autograd.Function):
    """Sum of the -2 log p terms over all windows, chunk by chunk. When the
    flat parameters need a gradient, the forward takes each chunk's value
    and gradient at once (its graph freed before the next chunk) and keeps
    the summed gradient; the backward scales it. Memory is one chunk's
    graph whatever N, as under the reference's checkpointed chunk scan.
    Runs on the windows' device and in their dtype; the parameters'
    ``pair_table`` is built once per evaluation and serves every chunk."""

    @staticmethod
    def forward(ctx, flat, windows, spec, geodesic, chunk):
        x = flat.detach().to(device=windows[0].device, dtype=windows[0].dtype)
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        grad = torch.zeros_like(x)
        table = pair_table(MaternParams.from_flat(x, spec=spec), x.device, x.dtype,
                           grad=ctx.needs_input_grad[0])
        for s in range(0, windows[0].shape[0], chunk):
            win = tuple(a[s:s + chunk] for a in windows)
            if ctx.needs_input_grad[0]:
                with torch.enable_grad():
                    xc = x.clone().requires_grad_(True)
                    v = _chunk_nll(xc, spec, win, geodesic, table)
                    (g,) = torch.autograd.grad(v, xc)
                grad += g
            else:
                v = _chunk_nll(x, spec, win, geodesic, table)
            total += v.detach()
        ctx.save_for_backward(grad)
        ctx.flat_like = (flat.device, flat.dtype)
        return total

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        device, dtype = ctx.flat_like
        return (ct * grad).to(device=device, dtype=dtype), None, None, None, None


def _windows_nll_sum(flat, windows, spec, geodesic, chunk):
    """Sum of -2 log p terms over the windows in ``chunk``-sized batches.
    Fully masked windows contribute exactly 0."""
    chunk = max(1, min(chunk, windows[0].shape[0]))
    return _WindowsNllSum.apply(torch.as_tensor(flat), tuple(windows), spec, geodesic, chunk)


def vecchia_nll(flat, win_coords, win_z, win_procs, win_mvar, win_mask, spec: ParamSpec,
                geodesic: bool = True, chunk: int = 4096):
    """Vecchia NLL over precomputed term windows, differentiable in ``flat``:
    0.5 * sum_i (u_m^2 + 2 log L_mm + log 2 pi), one (m+1)-point Cholesky
    per term, in ``chunk``-sized batches (memory bounded by one chunk)."""
    total = _windows_nll_sum(
        flat, (win_coords, win_z, win_procs, win_mvar, win_mask), spec, geodesic, chunk
    )
    return 0.5 * (total + win_coords.shape[0] * math.log(2.0 * math.pi))


def vecchia_nll_value_and_grad(flat, windows, spec, geodesic=True, chunk=4096):
    """(value, gradient) of the Vecchia NLL in ``flat`` over a
    ``VecchiaLikelihood``'s window tuple."""
    return _value_and_grad(
        lambda x: vecchia_nll(x, *windows, spec, geodesic, chunk), torch.as_tensor(flat)
    )


class VecchiaLikelihood:
    """Precomputed Vecchia scaffold (ordering + neighbor windows) of a fixed
    dataset, on ``device`` (the card unless ``device="cpu"``), exposing
    ``nll(flat, spec)``.

    Args:
        coords_list: per-process (n_j, 2) coordinate arrays.
        values_list: per-process (n_j,) residual arrays.
        m: conditioning-set size (accuracy rises and cost grows as O(m^3)
            per term).
        geodesic: haversine (km) or Euclidean distances.
        measurement_var_list: optional per-process measurement-error
            variances added to the term diagonals.
        ordering: "maxmin" (exact, N sequential device steps), "coarse"
            (``coarse_to_fine_order``) or "auto" (maxmin up to 20,000
            points, coarse beyond).
        neighbor_method: "device" (exact blocked top-k), "kd"
            (``nearest_previous_neighbors_kd``) or "auto" (device up to
            20,000, kd beyond).
        kd_exact_prefix: rows below this index take the exact search on
            the kd path.

    ``scaffold`` holds the build's host seconds (``order_s``,
    ``neighbors_s``, ``windows_s``: the gather and the copy to the device)
    and the windows' device bytes (``window_bytes``).
    """

    def __init__(self, coords_list, values_list, m: int = 30, geodesic: bool = True,
                 measurement_var_list=None, chunk: int = 4096, ordering: str = "auto",
                 neighbor_method: str = "auto", kd_exact_prefix: int = 4096,
                 device=None) -> None:
        dev = resolve_device(device)
        coords = np.concatenate([np.asarray(c) for c in coords_list])
        values = np.concatenate([np.asarray(v) for v in values_list])
        procs = np.concatenate([np.full(len(c), j, np.int64) for j, c in enumerate(coords_list)])
        mvar = None
        if measurement_var_list is not None:
            mvar = np.concatenate([np.asarray(v, values.dtype) for v in measurement_var_list])
        n = coords.shape[0]
        m = int(min(m, n - 1))
        self.n, self.m, self.geodesic, self.chunk, self.device = n, m, geodesic, chunk, dev
        if ordering == "auto":
            ordering = "maxmin" if n <= AUTO_THRESHOLD else "coarse"
        if neighbor_method == "auto":
            neighbor_method = "device" if n <= AUTO_THRESHOLD else "kd"
        self.ordering, self.neighbor_method = ordering, neighbor_method
        t0 = time.perf_counter()
        if ordering == "coarse":
            perm = coarse_to_fine_order(coords, geodesic)
        elif ordering == "maxmin":
            perm = maxmin_order(coords, geodesic, device=dev)
        else:
            raise ValueError(f"unknown ordering {ordering!r}")
        t1 = time.perf_counter()
        self.perm = perm
        coords, values, procs = coords[perm], values[perm], procs[perm]
        if mvar is not None:
            mvar = mvar[perm]
        if neighbor_method == "kd":
            nbr, nbr_mask = nearest_previous_neighbors_kd(
                coords, m, geodesic, exact_prefix=kd_exact_prefix
            )
        elif neighbor_method == "device":
            nbr, nbr_mask = nearest_previous_neighbors(coords, m, geodesic, device=dev)
        else:
            raise ValueError(f"unknown neighbor_method {neighbor_method!r}")
        t2 = time.perf_counter()
        self._win = _term_windows(coords, values, procs, mvar, nbr, nbr_mask, dev)
        self.scaffold = {"order_s": t1 - t0, "neighbors_s": t2 - t1,
                         "windows_s": time.perf_counter() - t2,
                         "window_bytes": sum(a.numel() * a.element_size() for a in self._win)}

    def nll(self, flat, spec: ParamSpec):
        return vecchia_nll(flat, *self._win, spec, self.geodesic, self.chunk)


def make_device_vecchia_lbfgs_fitter(spec: ParamSpec, geodesic: bool, maxiter: int = 200,
                                     tol: float = 1e-6, memory_size: int = 15,
                                     chunk: int = 4096):
    """Vecchia-likelihood fitter on the windows' device: the shared
    sigmoid-box L-BFGS loop (``estimate.nll.sigmoid_box_lbfgs``) over the
    Vecchia NLL, no host round trip per evaluation.

    Returns fit(x0, windows) -> (x, nll, n_iter, converged), ``windows`` a
    ``VecchiaLikelihood``'s ``_win`` tuple.
    """

    def fit(x0, windows):
        dt, dev = windows[0].dtype, windows[0].device
        lo, hi = _bounds(spec, dt, dev)

        def raw(x):
            return vecchia_nll(x, *windows, spec, geodesic, chunk)

        return sigmoid_box_lbfgs(
            raw, torch.as_tensor(x0, dtype=dt, device=dev), lo, hi,
            maxiter=maxiter, tol=tol, memory_size=memory_size,
        )

    return fit


def _likelihood(mf, m, use_measurement_var, main, chunk, device, **kw):
    coords = [f.coords_main if main else f.coords for f in mf.fields]
    values = [f.values_main if main else f.values for f in mf.fields]
    mvl = None
    if use_measurement_var:
        mvl = [f.measurement_var if f.measurement_var is not None else np.zeros(f.size)
               for f in mf.fields]
    return VecchiaLikelihood(coords, values, m=m, geodesic=mf.geodesic,
                             measurement_var_list=mvl, chunk=chunk, device=device, **kw)


def fit_vecchia_device(mf, init: Optional[MaternParams] = None, m: int = 30,
                       use_measurement_var: bool = False, maxiter: int = 200,
                       main: bool = True, chunk: int = 4096,
                       device=None) -> Tuple[MaternParams, dict]:
    """Vecchia-likelihood fit entirely on ``device`` (the card unless
    ``device="cpu"``) with ``make_device_vecchia_lbfgs_fitter``; the same
    optimum as the host fitter ``fit_vecchia``. Parameters come back in the
    windows' dtype."""
    init = init or MaternParams.default(mf.n_procs)
    spec = init.spec
    lik = _likelihood(mf, m, use_measurement_var, main, chunk, device)
    fit = make_device_vecchia_lbfgs_fitter(spec, lik.geodesic, maxiter=maxiter, chunk=chunk)
    x, nll, n_iter, conv = fit(init.to_flat().detach(), lik._win)
    params = MaternParams.from_flat(x.detach(), spec=spec)
    return params, {
        "nll": float(nll),
        "success": bool(conv),
        "n_iter": int(n_iter),
        "m": lik.m,
        "n": lik.n,
    }


def fit_vecchia(mf, init: Optional[MaternParams] = None, m: int = 30,
                use_measurement_var: bool = False, maxiter: int = 200, main: bool = True,
                chunk: int = 4096, mesh=None, ordering: str = "auto",
                neighbor_method: str = "auto", device=None) -> Tuple[MaternParams, dict]:
    """Maximum Vecchia-likelihood fit of the Matern parameters: scipy
    L-BFGS-B under the sigmoid box reparameterization over the Vecchia value
    and gradient on ``device`` (the card unless ``device="cpu"``), the fit
    path beyond the exact NLL's n ~ 25k. ``ordering`` and
    ``neighbor_method`` pass through to ``VecchiaLikelihood``.

    scipy's iterate is float64; every evaluation runs in the windows' dtype
    and the parameters come back in it, so a float32 dataset stays float32
    downstream. ``mesh``: optional ``parallel.Mesh``; the objective and its
    gradient then evaluate term-parallel over it
    (``parallel.mesh.sharded_windows_nll``, the windows placed on the
    shards once), with the unsharded evaluation's chunks. The info's
    ``scaffold`` is the likelihood's (``VecchiaLikelihood.scaffold``): the
    host seconds of the ordering, the neighbor search and the windows.
    """
    from scipy.optimize import minimize

    from cokriging_tpu_torch.parallel.mesh import check_mesh

    check_mesh(mesh)
    init = init or MaternParams.default(mf.n_procs)
    spec = init.spec
    lik = _likelihood(mf, m, use_measurement_var, main, chunk, device,
                      ordering=ordering, neighbor_method=neighbor_method)
    win_dt, dev = lik._win[0].dtype, lik.device
    lo_np, hi_np = spec.bounds()
    lo, hi = _bounds(spec, win_dt, dev)

    if mesh is None:
        def raw_u(u):
            return vecchia_nll(_box_forward(u, lo, hi), *lik._win, spec, lik.geodesic, chunk)
    else:
        from cokriging_tpu_torch.parallel.mesh import sharded_windows_nll, vecchia_shards

        shards = vecchia_shards(lik, mesh, chunk)

        def raw_u(u):
            return sharded_windows_nll(_box_forward(u, lo, hi), shards, spec, lik.geodesic,
                                       chunk, lik.n, dev)

    x0 = np.clip(
        init.to_flat().detach().cpu().numpy().astype(np.float64),
        lo_np + 1e-6 * (hi_np - lo_np),
        hi_np - 1e-6 * (hi_np - lo_np),
    )
    z0 = (x0 - lo_np) / (hi_np - lo_np)
    u0 = np.log(z0) - np.log1p(-z0)
    evals = {"n": 0}
    trace = []

    def fun(u):
        evals["n"] += 1
        v, g = _value_and_grad(raw_u, torch.as_tensor(u, dtype=win_dt, device=dev))
        g = g.cpu().numpy().astype(np.float64)
        # a single non-finite entry would poison L-BFGS's curvature memory
        g = np.where(np.isfinite(g), g, 0.0)
        v = float(v)
        v = v if np.isfinite(v) else 1e10
        trace.append(v)
        return v, g

    # tight ftol/gtol: under the sigmoid box the objective flattens near
    # saturated bounds, where scipy's defaults stop mid-ridge
    res = minimize(fun, u0, jac=True, method="L-BFGS-B",
                   options={"maxiter": maxiter, "ftol": 1e-13, "gtol": 1e-9, "maxcor": 20})
    x = lo_np + (hi_np - lo_np) / (1.0 + np.exp(-res.x))
    params = MaternParams.from_flat(torch.as_tensor(x, dtype=win_dt, device=dev), spec=spec)
    return params, {
        "nll": float(res.fun),
        "success": bool(res.success),
        "n_iter": int(res.nit),
        "n_obj_evals": evals["n"],
        "m": lik.m,
        "n": lik.n,
        "nll_trace": trace,
        "scaffold": lik.scaffold,
    }
