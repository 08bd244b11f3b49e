"""Exact Gaussian negative log-likelihood for the joint bivariate field.

Counterpart of ``cokriging_tpu/estimate/nll.py``. The joint covariance uses
the conventions of prediction (src/joint_prediction.py:124-153): Matern
blocks with the nugget on exact-zero distances, plus optional
per-observation measurement-error variance on the diagonal.

    nll(theta) = 0.5 * (z^T C^-1 z + logdet C + n log 2pi)

from one Cholesky factorization and two triangular solves
(``torch.linalg``). The large-n gradient is analytic: d(nll)/dC =
0.5 (C^-1 - beta beta^T), beta = C^-1 z, handed to the covariance blocks'
scalar-cotangent backward (``cov.matern._ScaledMaternBlock``; on the card
the block-gradient kernel). The fitters minimize it under the sigmoid box
transform: scipy L-BFGS-B on the host, or ``sigmoid_box_lbfgs`` and Adam on
the fit's device.
"""

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import block_covariance
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.estimate.wls import (
    _box_forward, _box_inverse, _ordered_sum, adam_cosine,
)
from cokriging_tpu_torch.kernels.distance import euclidean_matrix, haversine_matrix
from cokriging_tpu_torch.kernels.linalg import spd_inverse_from_chol
from cokriging_tpu_torch.utils.config import resolve_device


def joint_distance_blocks(coords_list, geodesic=True):
    """(p, p) nested list of cross-distance matrices between field
    coordinate sets (upper triangle computed, lower mirrored)."""
    p = len(coords_list)
    dist = haversine_matrix if geodesic else euclidean_matrix
    blocks = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(p):
            if i <= j:
                blocks[i][j] = dist(coords_list[i], coords_list[j])
            else:
                blocks[i][j] = blocks[j][i].T
    return blocks


def _penalty(n, dtype, device):
    """Value at a non-PD parameter point. Its size matters: too large
    (1e12) and the line search's quadratic interpolation after hitting it
    steps below float resolution and stalls at the previous iterate."""
    return torch.tensor(1e6 * (1.0 + 0.5 * n), dtype=dtype, device=device)


def _factor(cov):
    """(lower Cholesky factor, failed) of ``cov``; ``failed`` is a Python
    bool read from ``cholesky_ex``'s info (and the factor's diagonal, which
    a NaN input poisons without an error code)."""
    chol, info = torch.linalg.cholesky_ex(cov)
    bad = bool(info != 0) or not bool(torch.isfinite(chol.diagonal()).all())
    return chol, bad


def _nll_from_factor(chol, z):
    n = z.shape[0]
    alpha = torch.linalg.solve_triangular(chol, z[:, None], upper=False)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(chol.diagonal()))
    return 0.5 * (alpha @ alpha + logdet + n * math.log(2.0 * math.pi)), alpha


class _GaussianNll(torch.autograd.Function):
    """nll(C, z) with the closed-form cotangent d(nll)/dC = 0.5 (C^-1 -
    beta beta^T), beta = C^-1 z (the reference's custom VJP,
    cokriging_tpu/estimate/nll.py:134-162): one ``cholesky_inverse`` and one
    rank-one update instead of reverse mode through the factorization. At a
    non-PD point the value is the penalty and the cotangent is zero (the
    objective is locally constant there)."""

    @staticmethod
    def forward(ctx, cov, z):
        chol, bad = _factor(cov)
        ctx.bad = bad
        if bad:
            ctx.shape = cov.shape
            return _penalty(z.shape[0], cov.dtype, cov.device)
        nll, alpha = _nll_from_factor(chol, z)
        ctx.save_for_backward(chol, alpha)
        return nll

    @staticmethod
    def backward(ctx, ct):
        if ctx.bad:
            return torch.zeros(ctx.shape, dtype=ct.dtype, device=ct.device), None
        chol, alpha = ctx.saved_tensors
        g_cov = spd_inverse_from_chol(chol)
        beta = torch.linalg.solve_triangular(chol.T, alpha[:, None], upper=True)[:, 0]
        g_cov.addr_(beta, beta, alpha=-1.0)  # in place: C^-1 - beta beta^T
        return g_cov.mul_(0.5 * ct), None


def neg_log_likelihood(
    flat,
    dists,
    z,
    spec: ParamSpec,
    measurement_var=None,
    jitter: float = 0.0,
    analytic_grad=None,
):
    """Exact NLL of stacked residuals ``z`` under flat params;
    differentiable in ``flat``.

    Args:
        flat: flat parameter vector (reference ordering).
        dists: (p, p) nested list of distance blocks (precomputed, fixed
            across optimizer iterations).
        z: (n,) stacked residual vector over all processes.
        measurement_var: optional (n,) measurement-error variances added to
            the diagonal (prep_sif/prep_xco2 semantics,
            src/data_utils.py:28, 68).
        jitter: optional diagonal regularization.
        analytic_grad: route the gradient through the closed-form d(nll)/dC
            (``_GaussianNll``) and the blocks' scalar-cotangent backward.
            ``False`` differentiates straight through the factorization.
            The default ``None`` decides by problem size as the reference
            does (n > 4096 -> analytic), so small fits exercise plain AD.

    A non-PD parameter point (e.g. rho at +-1 with colocated samples) gives
    the finite penalty 1e6 (1 + n/2) and an exactly zero gradient, so line
    searches can back off instead of aborting.
    """
    if analytic_grad is None:
        analytic_grad = z.shape[0] > 4096
    params = MaternParams.from_flat(flat, spec=spec)
    cov = block_covariance(params, dists, h_grad=not analytic_grad)
    n = cov.shape[0]
    diag_extra = torch.full((n,), jitter, dtype=cov.dtype, device=cov.device)
    if measurement_var is not None:
        diag_extra = diag_extra + measurement_var
    cov.diagonal().add_(diag_extra)  # cov is this call's own buffer
    if analytic_grad:
        return _GaussianNll.apply(cov, z)
    # Plain AD through the factorization. The reference probes with a
    # stop-gradient Cholesky and swaps a failed input for the identity, so
    # that no NaN primal enters cholesky's VJP; eager torch reads the
    # factorization's info and leaves a failed one out of the graph.
    chol, bad = _factor(cov)
    if bad:
        return _penalty(n, cov.dtype, cov.device) + (flat * 0.0).sum()
    return _nll_from_factor(chol, z)[0]


def _clean_grad(g):
    """Zero non-finite gradient entries. At penalty (non-PD) points the
    objective is locally constant, so a zero gradient is the consistent
    value."""
    return torch.where(torch.isfinite(g), g, 0.0)


class _CleanGrad(torch.autograd.Function):
    """Identity whose backward is ``_clean_grad``."""

    @staticmethod
    def forward(ctx, u):
        return u.view_as(u)

    @staticmethod
    def backward(ctx, g):
        return _clean_grad(g)


def _value_and_grad(fn, x):
    x = x.detach().clone().requires_grad_(True)
    v = fn(x)
    (g,) = torch.autograd.grad(v, x)
    return v.detach(), g


def nll_value_and_grad(flat, dists, z, spec, measurement_var=None, jitter=0.0):
    """(value, cleaned gradient) of the NLL in the flat parameters."""
    v, g = _value_and_grad(
        lambda x: neg_log_likelihood(x, dists, z, spec, measurement_var, jitter), flat
    )
    return v, _clean_grad(g)


def _box_objective(raw, lo, hi):
    """u -> raw(lo + (hi - lo) sigmoid(u)), with a cleaned gradient in u."""
    return lambda u: raw(_box_forward(_CleanGrad.apply(u), lo, hi))


def nll_u_value_and_grad(u, lo, hi, dists, z, spec, measurement_var=None, jitter=0.0):
    """(value, cleaned gradient) of the NLL under the sigmoid box transform
    x = lo + (hi - lo) * sigmoid(u)."""
    return _value_and_grad(
        _box_objective(
            lambda x: neg_log_likelihood(x, dists, z, spec, measurement_var, jitter), lo, hi
        ),
        u,
    )


def _dot(a, b):
    """Row-wise dot products over the last axis, added in order (the same
    operations for a member alone and in any batch)."""
    return _ordered_sum(a * b)


def _lbfgs_direction(g, S, Y, rho, head, n_filled):
    """L-BFGS two-loop recursion of every member over its circular history
    (newest first): g (M, d), S and Y (M, m, d), rho (M, m), head (M,).
    ``n_filled`` is (fewest, most) filled slots over the members, host
    ints: older slots are empty for all and skipped, and the newest
    ``fewest`` are filled for all and need no mask (an empty slot, rho == 0,
    leaves q as it is)."""
    m = rho.shape[1]
    fewest, most = n_filled
    if most == 0:
        return -g
    order = (head[:, None] - 1 - torch.arange(most, device=head.device)) % m
    So = S.gather(1, order[..., None].expand(-1, -1, S.shape[2])).unbind(1)
    Yo = Y.gather(1, order[..., None].expand(-1, -1, Y.shape[2])).unbind(1)
    ro = rho.gather(1, order)
    valid = (ro > 0.0)[..., None].unbind(1)
    ro = ro.unbind(1)

    def masked(k, new, q):
        return new if k < fewest else torch.where(valid[k], new, q)

    q = g
    alphas = []
    for k in range(most):
        a = ro[k] * _dot(So[k], q)
        q = masked(k, q - a[:, None] * Yo[k], q)
        alphas.append(a)
    # initial Hessian scale from the newest pair (slots fill in order and
    # stay filled, so the newest is filled whenever any is)
    gamma = _dot(So[0], Yo[0]) / torch.clamp_min(_dot(Yo[0], Yo[0]), 1e-30)
    q = masked(0, gamma[:, None] * q, q)
    for k in range(most - 1, -1, -1):
        b = ro[k] * _dot(Yo[k], q)
        q = masked(k, q + (alphas[k] - b)[:, None] * So[k], q)
    return -q


def sigmoid_box_lbfgs_batch(
    raw, x0, lo, hi, maxiter: int = 200, tol: float = 1e-6,
    memory_size: int = 10, n_starts: int = 1,
):
    """Minimize B independent objectives over the box [lo, hi] with L-BFGS
    under the sigmoid reparameterization x = lo + (hi - lo) * sigmoid(u),
    all members at once on x0's device: the reference's
    ``sigmoid_box_lbfgs`` (cokriging_tpu/estimate/nll.py:196-429) as the
    reference's ``fit_wls_batch_arrays`` vmaps it, each member stepping
    until its own stop and frozen after it.

    ``raw(x, rows)`` evaluates the objectives of the members ``x`` (k, d),
    ``rows`` (k,) naming the batch row (0 .. B - 1) each belongs to, and
    returns their (k,) values; it must treat rows independently. ``x0`` is
    (B, d). Each batch row runs ``n_starts`` members: its own start and
    ``n_starts - 1`` deterministic box-fraction restarts.

    Every iteration evaluates one trial point u + alpha * d for each active
    member in one call of ``raw`` and either accepts it or moves that
    member's step bracket, every rule applied per member with masks; the
    host reads the card once per iteration (which members are active, which
    accepted their last trial and so need a new direction, and how full
    each curvature history is). Steps
    are searched by Lewis-Overton bracketing (Armijo failure caps the
    bracket, curvature failure raises its floor, doubling while
    unbracketed) with the safeguarded quadratic-interpolation candidate,
    which lands in the weak-Wolfe window (c1 = 1e-4, c2 = 0.9); after 20
    probes without an accept any Armijo point is taken, and 40 probes
    without one is a line-search failure. A curvature pair is stored only
    when s.y is positive relative to |s| |y|. Besides the gradient
    tolerance, three consecutive clean Wolfe accepts whose relative
    improvement stays below ftol stop a member (scipy's factr = 1e7 test,
    made robust to one tiny backtracked step). Gradients are cleaned
    (non-finite entries zeroed) so penalty-region probes cannot poison the
    curvature memory.

    Of a row's starts the best basin wins, preferring the row's own start
    unless a restart is better by a real margin (0.1% relative).

    Returns (x (B, d), value (B,), n_iter (B,) int64, converged (B,) bool):
    n_iter counts objective evaluations (accepts and line-search probes,
    summed over the row's starts); converged is True iff the winning start
    stopped on the gradient tolerance or the ftol test at a genuine point.
    A cleaned gradient of exactly zero means the iterate is stranded on the
    non-PD penalty plateau; that exit reports converged=False.
    """
    m = memory_size
    dt, dev = x0.dtype, x0.device
    B, d = x0.shape
    c1, c2 = 1e-4, 0.9
    ftol = 2.2e-9 if dt == torch.float64 else 1e-6

    starts = [x0]
    if n_starts > 1:
        fr = torch.linspace(0.25, 0.75, n_starts - 1, dtype=dt, device=dev)
        starts += [(lo + f * (hi - lo)).expand(B, d) for f in fr]
    # member r = row * n_starts + start
    u = _box_inverse(torch.stack(starts, dim=1).reshape(B * n_starts, d), lo, hi)
    rows = torch.arange(B, device=dev).repeat_interleave(n_starts)
    M = u.shape[0]

    def value_and_grad(ut, rows_t):
        ut = ut.detach().clone().requires_grad_(True)
        v = raw(_box_forward(_CleanGrad.apply(ut), lo, hi), rows_t)
        (g,) = torch.autograd.grad(v.sum(), ut)
        return v.detach(), g

    f, g = value_and_grad(u, rows)
    gg = _dot(g, g)  # |g|^2, kept beside g
    S = torch.zeros((M, m, d), dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((M, m), dtype=dt, device=dev)
    head = torch.zeros(M, dtype=torch.int64, device=dev)
    dvec = -g
    alpha = torch.clamp_max(1.0 / torch.clamp_min(torch.sqrt(gg), 1e-12), 1.0)
    alo = torch.zeros(M, dtype=dt, device=dev)
    ahi = torch.full((M,), math.inf, dtype=dt, device=dev)
    evals = torch.zeros(M, dtype=torch.int64, device=dev)
    bt = torch.zeros_like(evals)
    n_small = torch.zeros_like(evals)
    fail = torch.zeros(M, dtype=torch.bool, device=dev)
    accepted = torch.zeros(M, dtype=torch.bool, device=dev)  # a new direction is due
    while True:
        active = (evals < maxiter) & (torch.sqrt(gg) >= tol) & ~fail & (n_small < 3)
        # the one host read of the iteration: who steps, who accepted its
        # last trial, and how full each history is
        state = torch.cat([active.long(), (accepted & active).long(),
                           torch.clamp_max(head, m)]).cpu().numpy()
        idx_np = np.flatnonzero(state[:M])
        if idx_np.size == 0:
            break
        # new directions of the members that accepted (a rejected trial
        # keeps its direction)
        new_np = np.flatnonzero(state[M:2 * M])
        if new_np.size:
            filled = state[2 * M:][new_np]
            n_filled = (int(filled.min()), int(filled.max()))
            if new_np.size == M:
                dvec = _lbfgs_direction(g, S, Y, rho, head, n_filled)
            else:
                k = torch.as_tensor(new_np, device=dev)
                dvec[k] = _lbfgs_direction(g[k], S[k], Y[k], rho[k], head[k], n_filled)
        full = idx_np.size == M
        idx = None if full else torch.as_tensor(idx_np, device=dev)

        def take(t):
            return t if full else t[idx]

        def put(t, v):
            if full:
                return v
            t[idx] = v
            return t

        u_a, f_a, g_a, gg_a, d_a = (take(t) for t in (u, f, g, gg, dvec))
        al, lo_a, hi_a, bt_a, ns_a = (take(t) for t in (alpha, alo, ahi, bt, n_small))
        S_a, Y_a, rho_a, head_a = (take(t) for t in (S, Y, rho, head))
        ut = u_a + al[:, None] * d_a
        ft, gt = value_and_grad(ut, take(rows))
        s, y = ut - u_a, gt - g_a
        # the iteration's six dot products in one ordered sum (each the
        # same additions as alone)
        slope, gt_d, curv, ss, yy, gtt = _ordered_sum(
            torch.stack([g_a * d_a, gt * d_a, s * y, s * s, y * y, gt * gt])).unbind(0)
        armijo = ft <= f_a + c1 * al * slope
        curv_ok = gt_d >= c2 * slope
        accept = armijo & (curv_ok | (bt_a >= 20))
        # only clean Wolfe accepts count toward the ftol stop: a forced
        # accept makes tiny progress by construction
        small = (f_a - ft) <= ftol * torch.clamp_min(torch.abs(ft), 1.0)
        ns_n = torch.where(armijo & curv_ok, torch.where(small, ns_a + 1, 0), ns_a)
        # accept: store the curvature pair and step
        store = accept & (curv > 1e-10 * torch.sqrt(ss * yy))
        slot = torch.nn.functional.one_hot(head_a % m, m).bool() & store[:, None]
        S_a = torch.where(slot[..., None], s[:, None], S_a)
        Y_a = torch.where(slot[..., None], y[:, None], Y_a)
        rho_a = torch.where(slot, (1.0 / torch.clamp_min(curv, 1e-30))[:, None], rho_a)
        head_a = head_a + store.long()
        # reject: a curvature failure raises the floor, an Armijo failure
        # caps the bracket; then the minimizer of the 1-d quadratic through
        # (f, slope, ft), safeguarded into the open bracket, bisection when
        # degenerate, doubling while unbracketed
        lo_r = torch.where(armijo, al, lo_a)
        hi_r = torch.where(armijo, hi_a, al)
        denom = 2.0 * (ft - f_a - slope * al)
        alpha_q = torch.where(
            denom > 0.0, -slope * al * al / torch.clamp_min(denom, 1e-30),
            0.5 * (lo_r + torch.minimum(hi_r, 2.0 * al)),
        )
        top = torch.minimum(hi_r, 4.0 * al)
        alpha_q = torch.minimum(torch.maximum(alpha_q, lo_r + 0.1 * (top - lo_r)),
                                lo_r + 0.9 * (top - lo_r))
        alpha_r = torch.where(torch.isfinite(hi_r), alpha_q, 2.0 * al)
        bt_n = torch.where(accept, 0, bt_a + 1)
        u = put(u, torch.where(accept[:, None], ut, u_a))
        f = put(f, torch.where(accept, ft, f_a))
        g = put(g, torch.where(accept[:, None], gt, g_a))
        gg = put(gg, torch.where(accept, gtt, gg_a))
        S, Y, rho, head = put(S, S_a), put(Y, Y_a), put(rho, rho_a), put(head, head_a)
        alpha = put(alpha, torch.where(accept, 1.0, alpha_r))
        alo = put(alo, torch.where(accept, 0.0, lo_r))
        ahi = put(ahi, torch.where(accept, math.inf, hi_r))
        fail = put(fail, take(fail) | (~accept & (bt_n > 40)))
        bt, n_small = put(bt, bt_n), put(n_small, ns_n)
        evals = put(evals, take(evals) + 1)
        accepted = put(accepted, accept)
    err = torch.sqrt(gg)
    genuine = (err > 0.0) & torch.isfinite(f) & ~fail
    conv = ((err < tol) | (n_small >= 3)) & genuine
    # per row, the best basin: the row's own start unless a restart is
    # better by a real margin (near-ties between basins would otherwise let
    # summation-order noise flip the winner)
    v = f.reshape(B, n_starts).cpu().numpy().astype(np.float64)
    k = np.zeros(B, dtype=np.int64)
    for b in range(B):
        v0 = v[b, 0]
        thresh = v0 - max(1e-3 * abs(v0), 1e-6) if math.isfinite(v0) else math.inf
        for i in range(1, n_starts):
            if math.isfinite(v[b, i]) and v[b, i] < thresh and (k[b] == 0 or v[b, i] < v[b, k[b]]):
                k[b] = i
    win = torch.as_tensor(k, device=dev) + n_starts * torch.arange(B, device=dev)
    return (_box_forward(u[win], lo, hi), f[win], (evals + 1).reshape(B, n_starts).sum(1),
            conv[win])


def sigmoid_box_lbfgs(
    raw, x0, lo, hi, maxiter: int = 200, tol: float = 1e-6,
    memory_size: int = 10, n_starts: int = 1,
):
    """Minimize ``raw(x)`` over the box [lo, hi] with L-BFGS under the
    sigmoid reparameterization x = lo + (hi - lo) * sigmoid(u), on x0's
    device: the reference's algorithm step for step
    (cokriging_tpu/estimate/nll.py:196-429), ``sigmoid_box_lbfgs_batch``
    of the one instance, its ``n_starts`` starts in one batch (each start's
    objective evaluated in turn).

    ``n_starts > 1`` adds deterministic box-fraction restarts and returns
    the best basin, preferring the caller's start unless a restart is better
    by a real margin (0.1% relative): multimodal WLS costs need this to
    match scipy's basin.

    Returns (x, value, n_iter, converged): n_iter counts objective
    evaluations (accepts and line-search probes, summed over starts);
    converged is True iff the winning start stopped on the gradient
    tolerance or the ftol test at a genuine point.
    """
    x, v, n, conv = sigmoid_box_lbfgs_batch(
        lambda x, rows: torch.stack([raw(xi) for xi in x]), x0[None], lo, hi,
        maxiter=maxiter, tol=tol, memory_size=memory_size, n_starts=n_starts,
    )
    return x[0], v[0], int(n[0]), bool(conv[0])


def _bounds(spec, dtype, device):
    lo, hi = spec.bounds()
    return (torch.as_tensor(lo, dtype=dtype, device=device),
            torch.as_tensor(hi, dtype=dtype, device=device))


def make_device_nll_lbfgs_fitter(spec: ParamSpec, maxiter=200, tol=1e-6, memory_size=15):
    """Maximum-likelihood fitter on the data's device: ``sigmoid_box_lbfgs``
    on the NLL. It reaches the same tight optima as the host scipy fit (``fit_nll``)
    without a host round trip per evaluation.

    Returns fit(x0, dists, z, measurement_var, jitter)
    -> (x, nll, n_iter, converged).
    """

    def fit(x0, dists, z, measurement_var, jitter):
        lo, hi = _bounds(spec, z.dtype, z.device)

        def raw(x):
            return neg_log_likelihood(x, dists, z, spec, measurement_var, jitter)

        return sigmoid_box_lbfgs(
            raw, torch.as_tensor(x0, dtype=z.dtype, device=z.device), lo, hi,
            maxiter=maxiter, tol=tol, memory_size=memory_size,
        )

    return fit


def make_device_nll_fitter(spec: ParamSpec, maxiter=500, lr=0.1):
    """Maximum-likelihood fitter on the data's device: Adam with a cosine
    learning-rate decay on the sigmoid-box-transformed NLL, tracking the
    best iterate (the non-PD penalty plateau has zero gradient, so momentum
    can strand the last iterate there even though earlier steps were fine).

    First-order Adam trades optimum tightness for a fixed trip count on the
    stiff NLL surface; prefer ``make_device_nll_lbfgs_fitter`` or ``fit_nll``
    when optimum quality matters.

    Returns fit(x0, dists, z, measurement_var, jitter) -> (x, nll).
    """
    def fit(x0, dists, z, measurement_var, jitter):
        lo, hi = _bounds(spec, z.dtype, z.device)
        objective = _box_objective(
            lambda x: neg_log_likelihood(x, dists, z, spec, measurement_var, jitter), lo, hi
        )
        u0 = _box_inverse(torch.as_tensor(x0, dtype=z.dtype, device=z.device), lo, hi)
        with torch.no_grad():
            best = [u0, objective(u0)]

        def track(u, value):
            if bool(value < best[1]):
                best[:] = [u, value]

        u = adam_cosine(objective, u0, maxiter, lr=lr, callback=track)
        with torch.no_grad():
            track(u, objective(u))
            return _box_forward(best[0], lo, hi), best[1]

    return fit


def _fit_inputs(mf, init, use_measurement_var, main, device):
    """(init, distance blocks, stacked residuals, measurement variances) of
    a MultiField on ``device``, in the residuals' dtype."""
    init = init or MaternParams.default(mf.n_procs)
    coords = [f.coords_main if main else f.coords for f in mf.fields]
    values = [f.values_main if main else f.values for f in mf.fields]
    z = torch.cat([torch.as_tensor(v) for v in values]).to(device)
    dists = joint_distance_blocks(
        [torch.as_tensor(c).to(device=device, dtype=z.dtype) for c in coords],
        geodesic=mf.geodesic,
    )
    mvar = None
    if use_measurement_var:
        mvar = torch.cat(
            [
                torch.as_tensor(f.measurement_var, dtype=z.dtype)
                if f.measurement_var is not None
                else torch.zeros(f.size, dtype=z.dtype)
                for f in mf.fields
            ]
        ).to(device)
    return init, dists, z, mvar


def fit_nll_device(
    mf,
    init: Optional[MaternParams] = None,
    use_measurement_var: bool = False,
    jitter: float = 1e-8,
    maxiter: int = 200,
    main: bool = True,
    method: str = "lbfgs",
    device=None,
) -> Tuple[MaternParams, dict]:
    """Maximum-likelihood fit entirely on ``device`` (the card unless
    ``device="cpu"``), in the dtype of the field values.

    ``method="lbfgs"`` (default) is ``sigmoid_box_lbfgs`` and matches the
    host scipy fit's optima; ``method="adam"`` is the fixed-trip
    first-order fitter (looser optimum).
    """
    dev = resolve_device(device)
    init, dists, z, mvar = _fit_inputs(mf, init, use_measurement_var, main, dev)
    spec = init.spec
    x0 = init.to_flat().detach()
    if method == "lbfgs":
        fitter = make_device_nll_lbfgs_fitter(spec, maxiter)
        x, nll, n_iter, success = fitter(x0, dists, z, mvar, jitter)
    elif method == "adam":
        x, nll = make_device_nll_fitter(spec, maxiter)(x0, dists, z, mvar, jitter)
        n_iter = maxiter
        # fixed-trip Adam has no stopping test; a finite objective is the
        # only convergence signal available
        success = math.isfinite(float(nll))
    else:
        raise ValueError(f"unknown device NLL method: {method!r}")
    params = MaternParams.from_flat(x.detach(), spec=spec)
    return params, {
        "nll": float(nll),
        "success": bool(success),
        "n_iter": int(n_iter),
        "n_obj_evals": int(n_iter),
    }


def fit_nll(
    mf,
    init: Optional[MaternParams] = None,
    use_measurement_var: bool = False,
    jitter: float = 1e-8,
    maxiter: int = 200,
    main: bool = True,
    device=None,
) -> Tuple[MaternParams, dict]:
    """Maximum-likelihood fit of the Matern parameters to a MultiField.

    The box constraint is enforced by a sigmoid reparameterization and the
    unconstrained problem solved with scipy L-BFGS-B over
    ``nll_u_value_and_grad`` on ``device``. (A bound-constrained L-BFGS-B in
    raw space stalls here: its first Cauchy step projects onto a bound
    corner, e.g. rho = -1 with colocated samples, where the covariance is
    exactly singular, and the penalty value collapses the line-search
    interpolation to a zero step. Under the transform those corners sit at
    u = +-inf and are unreachable.) Distance blocks are assembled once and
    stay on the device across all objective evaluations; each evaluation
    runs in the dtype of the field values, and the parameters come back in
    it.
    """
    from scipy.optimize import minimize

    dev = resolve_device(device)
    init, dists, z, mvar = _fit_inputs(mf, init, use_measurement_var, main, dev)
    spec = init.spec
    lo_np, hi_np = spec.bounds()
    lo, hi = _bounds(spec, z.dtype, dev)
    x0 = np.clip(
        init.to_flat().detach().cpu().numpy().astype(np.float64),
        lo_np + 1e-6 * (hi_np - lo_np),
        hi_np - 1e-6 * (hi_np - lo_np),
    )
    z0 = (x0 - lo_np) / (hi_np - lo_np)
    u0 = np.log(z0) - np.log1p(-z0)
    evals = {"n": 0}

    def fun(u):
        evals["n"] += 1
        v, g = nll_u_value_and_grad(
            torch.as_tensor(u, dtype=z.dtype, device=dev), lo, hi, dists, z, spec, mvar, jitter
        )
        return float(v), g.cpu().numpy().astype(np.float64)

    res = minimize(fun, u0, jac=True, method="L-BFGS-B", options={"maxiter": maxiter})
    if not res.success:
        warnings.warn("NLL optimization did not converge.")
    x_fit = lo_np + (hi_np - lo_np) / (1.0 + np.exp(-res.x))
    params = MaternParams.from_flat(
        torch.as_tensor(x_fit, dtype=z.dtype, device=dev), spec=spec
    )
    info = {
        "nll": float(res.fun),
        "success": bool(res.success),
        "n_iter": int(res.nit),
        "n_obj_evals": evals["n"],
    }
    return params, info
