r"""Multivariate (bivariate) Matern cross-covariance model.

Counterpart of ``cokriging_tpu/cov/matern.py``, with the reference's
conventions (src/model.py:173-247):

- ``matern_correlation``: log-space Matern correlation with K_nu; h == 0 -> 1;
  non-finite -> 0; clamped >= 0;
- ``covariance(i, h)`` = sigma_i^2 M_ii(h), nugget added only at exactly
  h == 0;
- ``cross_covariance(i, j, h)`` = rho_ij sigma_i sigma_j M_ij(h);
- ``semivariance`` and ``cross_semivariance`` with the pair sill
  0.5 (sigma_i^2 + tau_i^2 + sigma_j^2 + tau_j^2).

The elementwise functions are plain, differentiable torch on every device
(the WLS cost and the prediction vector use them). ``block_covariance``
assembles whole distance blocks: on a CUDA tensor through the hand-written
kernels, ``kernels.cuda_ops.matern_correlation_block`` forward and
``kernels.cuda_ops.matern_block_grad`` backward, each block with its pair's
rows of the ``pair_table`` built once per call. ``gathered_covariance`` and
``windows_covariance`` assemble mixed-process entries from gathered process
ids (the matrix-free CG rows, the direct local systems, the Vecchia
windows); their correlations go through ``matern_corr_pairs``, on a CUDA
tensor the gathered-pairs kernels ``kernels.cuda_ops.matern_corr_pairs``
forward and ``matern_corr_pairs_grad`` backward. A caller that assembles many
tiles with one parameter set builds their ``PairTable`` once (``pair_table``)
and passes it down, so the tiles copy nothing from the host.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from cokriging_tpu_torch.cov.params import MaternParams
from cokriging_tpu_torch.kernels.bessel import kv, lgamma

_LN2 = math.log(2.0)


def matern_correlation(nu, len_scale, h, order_steps=None):
    r"""Matern correlation :math:`\rho(h)` in log space (src/model.py:354-385).

    .. math::
        \rho(h) = \frac{2^{1-\nu}}{\Gamma(\nu)}
                  (\sqrt{2\nu} h/\ell)^{\nu} K_\nu(\sqrt{2\nu} h/\ell)

    Elementwise over broadcast ``nu``, ``len_scale`` and ``h``;
    differentiable in all three. ``order_steps``: K_nu's fixed order
    recurrence count for a traced program (``kernels.bessel.kv``), or None.
    """
    h = torch.as_tensor(h)
    if not h.is_floating_point():
        h = h.to(torch.get_default_dtype())
    nu = torch.as_tensor(nu, dtype=h.dtype, device=h.device)
    len_scale = torch.as_tensor(len_scale, dtype=h.dtype, device=h.device)
    h = torch.abs(h)
    positive = h > 0.0
    hs = torch.where(positive, h, 1.0) / len_scale
    arg = torch.sqrt(2.0 * nu) * hs
    log_pref = (1.0 - nu) * _LN2 - lgamma(nu) + nu * torch.log(arg)
    corr = torch.exp(log_pref) * kv(nu, arg, order_steps)
    corr = torch.where(torch.isfinite(corr), corr, 0.0)
    corr = torch.clamp_min(corr, 0.0)
    return torch.where(positive, corr, 1.0)


def correlation(params: MaternParams, i: int, j: int, h):
    """Pairwise Matern correlation M_ij(h) (src/model.py:188-191)."""
    return matern_correlation(params.nu[i, j], params.len_scale[i, j], h)


def covariance(params: MaternParams, i: int, h, use_nugget: bool = True):
    """Marginal covariance of process i; nugget only at h == 0
    (src/model.py:193-197)."""
    h = torch.as_tensor(h)
    cov = params.sigma[i] ** 2 * correlation(params, i, i, h)
    if use_nugget:
        cov = cov + torch.where(h == 0.0, params.nugget[i], 0.0)
    return cov


def cross_covariance(params: MaternParams, i: int, j: int, h):
    """Cross-covariance between processes i and j (src/model.py:199-207)."""
    scale = params.rho[i, j] * params.sigma[i] * params.sigma[j]
    return scale * correlation(params, i, j, h)


def semivariance(params: MaternParams, i: int, h):
    """Marginal semivariogram (src/model.py:209-213)."""
    return (
        params.sigma[i] ** 2 * (1.0 - correlation(params, i, i, h))
        + params.nugget[i]
    )


def cross_semivariance(params: MaternParams, i: int, j: int, h):
    """Cross-semivariogram = pair sill - C_ij(h) (src/model.py:215-222)."""
    sill = 0.5 * (
        params.sigma[i] ** 2
        + params.nugget[i]
        + params.sigma[j] ** 2
        + params.nugget[j]
    )
    return sill - cross_covariance(params, i, j, h)


def variogram_value(params: MaternParams, i: int, j: int, h, covariogram=False):
    """Theoretical (cross-)variogram of the given kind (src/model.py:224-237)."""
    if covariogram:
        if i == j:
            return covariance(params, i, h)
        return cross_covariance(params, i, j, h)
    if i == j:
        return semivariance(params, i, h)
    return cross_semivariance(params, i, j, h)


class _ScaledMaternBlock(torch.autograd.Function):
    """One covariance block C = scale * M(nu, ls, h) + nugget * [h == 0]
    with scalar-only cotangents (the reference's ``_make_scaled_cvjp``,
    cokriging_tpu/cov/matern.py:180-293): the backward returns the four
    scalar gradients and none for ``h``, which is data. On a CUDA tensor the
    forward is the Matern kernel and the backward the block-gradient kernel,
    both reading pair ``k``'s rows of ``table``, a ``pair_table`` (or, with
    ``table`` None, building them per launch); on the CPU both are their
    plain versions. ``symmetric`` (marginal self-distance blocks) lets both
    evaluate the lower triangle only. The backward is the differentiable
    ``_ScaledMaternBlockGrad``, so a Hessian runs through the block."""

    @staticmethod
    def forward(ctx, scale, nugget, nu, ls, h, symmetric, table=None, k=None):
        from cokriging_tpu_torch.kernels.cuda_ops import matern_correlation_block

        ctx.save_for_backward(scale, nugget, nu, ls, h)
        ctx.symmetric = symmetric
        ctx.table, ctx.k = table, k
        out = matern_correlation_block(nu.detach(), ls.detach(), h, symmetric=symmetric,
                                       table=None if table is None else table.value[k])
        out.mul_(scale)
        return out.add_(torch.where(h == 0.0, nugget.to(out.dtype), 0.0))

    @staticmethod
    def backward(ctx, ct):
        scale, nugget, nu, ls, h = ctx.saved_tensors
        g = _ScaledMaternBlockGrad.apply(scale, nugget, nu, ls, h, ct.to(h.dtype), ctx.symmetric,
                                         ctx.table, ctx.k)
        return (g[0].to(scale.dtype), g[1].to(nugget.dtype), g[2].to(nu.dtype),
                g[3].to(ls.dtype), None, None, None, None)


class _ScaledMaternBlockGrad(torch.autograd.Function):
    """The block's four scalar gradients g = (sum ct M, sum ct [h == 0],
    scale sum ct dM/dnu, scale sum ct dM/dls) as a function of (scale,
    nugget, nu, ls) and the cotangent ct, so that a double backward (a
    Hessian) runs through the block. The forward is the block-gradient
    kernel (``matern_block_grad``; the only launch of a first-order
    backward). The backward, for a cotangent v of g, gives ct the block's
    tangent along v (``matern_block_tangent``: v_s M + v_n [h == 0] +
    scale (v_nu dM/dnu + v_ls dM/dls)) and (scale, nugget, nu, ls) the
    4 x 4 contraction of the five second-order sums of ``matern_block_hess``
    (sum ct dM/dnu, sum ct dM/dls and the three sums of ct times M's second
    partials) with v; nugget gets 0. On a CUDA tensor both are the kernels
    of ``csrc/matern_hess.cu``, on the CPU their plain versions. All read
    pair ``k``'s rows of ``table`` where it has them (the second-order row
    built once for every block of a ``pair_table``, ``SecondRows``) and
    build theirs per launch where not. The backward is not differentiable
    again."""

    @staticmethod
    def forward(ctx, scale, nugget, nu, ls, h, ct, symmetric, table=None, k=None):
        from cokriging_tpu_torch.kernels.cuda_ops import matern_block_grad

        ctx.save_for_backward(scale, nu, ls, h, ct)
        ctx.symmetric = symmetric
        ctx.dual_row = None if table is None or table.dual is None else table.dual[k]
        ctx.second = None if table is None or table.second is None else (table.second, k)
        return matern_block_grad(scale, nugget, nu, ls, h, ct, symmetric, table=ctx.dual_row)

    @staticmethod
    @once_differentiable
    def backward(ctx, v):
        from cokriging_tpu_torch.kernels.cuda_ops import matern_block_hess, matern_block_tangent

        scale, nu, ls, h, ct = ctx.saved_tensors
        v = v.to(torch.float64)
        g_s = g_nu = g_ls = g_ct = None
        need = ctx.needs_input_grad
        if need[0] or need[2] or need[3]:
            # the sums do not depend on v: one launch serves every row of a Hessian
            if not hasattr(ctx, "sums"):
                ctx.sums = matern_block_hess(
                    nu, ls, h, ct, ctx.symmetric,
                    table=None if ctx.second is None else ctx.second[0].row(ctx.second[1]))
            a_nu, a_ls, h_nn, h_nl, h_ll = ctx.sums
            s = scale.to(torch.float64)
            g_s = (v[2] * a_nu + v[3] * a_ls).to(scale.dtype)
            g_nu = (v[0] * a_nu + s * (v[2] * h_nn + v[3] * h_nl)).to(nu.dtype)
            g_ls = (v[0] * a_ls + s * (v[2] * h_nl + v[3] * h_ll)).to(ls.dtype)
        if need[5]:
            g_ct = matern_block_tangent(scale, nu, ls, h, v, ctx.symmetric,
                                        table=ctx.dual_row).to(ct.dtype)
        g_n = torch.zeros_like(scale) if need[1] else None
        return g_s, g_n, g_nu, g_ls, None, g_ct, None, None, None


def _needs_grad(params: MaternParams) -> bool:
    """Whether autograd will differentiate a covariance of ``params``."""
    return torch.is_grad_enabled() and any(
        t.requires_grad
        for t in (params.sigma, params.nu, params.len_scale, params.nugget, params.rho)
    )


def block_covariance(params: MaternParams, dists, h_grad: bool = True, table=None):
    """Assemble the joint block covariance for p processes.

    ``dists[i][j]`` is the (n_i, n_j) distance matrix between the
    observation sets of processes i and j; only i <= j entries are read
    (lower blocks are transposes, src/joint_prediction.py:124-153). Marginal
    blocks are self-distance matrices, symmetric by construction, so the
    kernels evaluate their lower triangle only.

    On a CUDA tensor every block, float32 or float64, goes through the
    hand-written kernels: ``matern_correlation_block`` forward and, when a
    parameter requires grad, ``matern_block_grad`` backward
    (``_ScaledMaternBlock``); the distances get no gradient there. Both read
    the block's rows of ``table``, the parameters' ``pair_table`` (built
    here once per call when None), so neither reads the card from the
    host. On the
    CPU, ``h_grad=True`` differentiates the plain elementwise model (in the
    distances too), and ``h_grad=False`` (distances are data) takes the
    same block Function with the kernels' plain versions.
    """
    from cokriging_tpu_torch.kernels.cuda_ops import matern_correlation_block

    p = params.n_procs
    h00 = torch.as_tensor(dists[0][0])
    on_card = h00.is_cuda
    needs_grad = _needs_grad(params)
    if on_card and table is None:
        table = pair_table(params, h00.device, h00.dtype)
    blocks = {}
    for i in range(p):
        for j in range(i, p):
            h = torch.as_tensor(dists[i][j])
            if on_card and h_grad and torch.is_grad_enabled() and h.requires_grad:
                raise ValueError(
                    "block_covariance: the kernels on the card give the distances no gradient"
                )
            if i == j:
                scale, nugget = params.sigma[i] ** 2, params.nugget[i]
            else:
                scale = params.rho[i, j] * params.sigma[i] * params.sigma[j]
                nugget = torch.zeros((), dtype=scale.dtype, device=scale.device)
            k = table.number(i, j) if on_card else None
            if needs_grad and (on_card or not h_grad):
                blocks[(i, j)] = _ScaledMaternBlock.apply(
                    scale, nugget, params.nu[i, j], params.len_scale[i, j], h, i == j,
                    table if on_card else None, k,
                )
                continue
            m = matern_correlation_block(
                params.nu[i, j], params.len_scale[i, j], h, symmetric=(i == j),
                table=table.value[k] if on_card else None,
            )
            blocks[(i, j)] = scale * m
            if i == j:
                blocks[(i, j)] = blocks[(i, j)] + torch.where(h == 0.0, nugget, 0.0)
    return torch.cat(
        [
            torch.cat(
                [blocks[(i, j)] if i <= j else blocks[(j, i)].T for j in range(p)],
                dim=1,
            )
            for i in range(p)
        ],
        dim=0,
    )


def covariance_block(params: MaternParams, i: int, j: int, d, table=None):
    """Covariance block between process i and process j at the 2-D
    distances ``d`` (nugget at exact zeros when i == j), like the blocks of
    the joint covariance: ``matern_correlation_block``, on a CUDA tensor the
    Matern kernel, with the pair's row of ``table`` (the parameters'
    ``pair_table``) where it is of d's dtype."""
    from cokriging_tpu_torch.kernels.cuda_ops import matern_correlation_block

    row = None
    if table is not None and d.is_cuda and d.dtype == table.value.dtype:
        row = table.rows(i, j)[0]
    m = matern_correlation_block(params.nu[i, j], params.len_scale[i, j], d, table=row)
    if i == j:
        return m.mul_(params.sigma[i] ** 2).add_(torch.where(d == 0.0, params.nugget[i], 0.0))
    return m.mul_(params.rho[i, j] * params.sigma[i] * params.sigma[j])


def joint_covariance_from_coords(params: MaternParams, coords_tuple, geodesic):
    """The joint block covariance of the per-process coordinate sets
    ``coords_tuple``: their cross-distance blocks, then ``block_covariance``
    (on the card through the Matern kernel), on the coordinates' device."""
    from cokriging_tpu_torch.estimate.nll import joint_distance_blocks

    return block_covariance(params, joint_distance_blocks(list(coords_tuple), geodesic=geodesic))


def _pairs(p):
    """The process pairs i <= j in row order; pair number k is the k-th."""
    return [(i, j) for i in range(p) for j in range(i, p)]


def _pair_number(i, j, p):
    """The pair number of processes i <= j (ints or tensors) in row order."""
    return i * p - i * (i - 1) // 2 + j - i


def _pair_stacks(params: MaternParams):
    """The (n_pairs,) stacks of nu and len_scale of the process pairs."""
    pairs = _pairs(params.n_procs)
    return (torch.stack([params.nu[i, j] for i, j in pairs]),
            torch.stack([params.len_scale[i, j] for i, j in pairs]))


class PairTable(NamedTuple):
    """What the covariance kernels need beyond the parameters' autograd
    values, built once per parameter set by ``pair_table``: ``index``, the
    (p, p) pair number k of each process pair (symmetric, i <= j in row
    order), and on a CUDA device the kernels' recurrence tables
    (``kernels.cuda_ops.recurrence_table``), one row per pair: ``value`` for
    the forward kernels, ``dual`` for the gradient kernels (None where no
    gradient was asked for; both None off the card), and ``second`` the
    Hessian sums' second-order rows, built on first use (``SecondRows``;
    None where ``dual`` is)."""

    index: torch.Tensor
    value: Optional[torch.Tensor]
    dual: Optional[torch.Tensor]
    second: Optional["SecondRows"] = None

    def number(self, i: int, j: int) -> int:
        """The pair number of processes (i, j), worked out on the host
        (``index`` stays on the device)."""
        return _pair_number(min(i, j), max(i, j), self.index.shape[0])

    def rows(self, i: int, j: int):
        """(value row, dual row or None) of the process pair (i, j)."""
        k = self.number(i, j)
        return self.value[k], None if self.dual is None else self.dual[k]


class SecondRows:
    """The process pairs' second-order rows of the Hessian sums
    (``recurrence_table(..., order=2)``, ~500-900 small torch operations),
    built in one call for every pair on the first request, which is the first
    block's double backward of a Hessian, and then shared by every block of
    the covariance: one build per Hessian, none where nothing asks for
    one."""

    def __init__(self, nu_pairs, ls_pairs, dtype):
        self._args = (nu_pairs, ls_pairs, dtype)
        self._table = None

    def row(self, k: int):
        if self._table is None:
            from cokriging_tpu_torch.kernels.cuda_ops import recurrence_table

            self._table = recurrence_table(*self._args, order=2)
        return self._table[k]


def pair_table(params: MaternParams, device, dtype, grad: Optional[bool] = None) -> PairTable:
    """The ``PairTable`` of ``params`` for distances of ``dtype`` on
    ``device``: the pair numbers and, on a card, the kernels' tables, all
    made there from the parameters' values with no host copy, the dual
    one only when ``grad`` (by default: when autograd will differentiate a
    covariance of ``params``)."""
    p = params.n_procs
    device = torch.device(device)
    r = torch.arange(p, device=device)
    index = _pair_number(torch.minimum(r[:, None], r[None, :]),
                         torch.maximum(r[:, None], r[None, :]), p)
    if device.type != "cuda":
        return PairTable(index, None, None)
    return PairTable(index, *_kernel_tables(params, device, dtype,
                                            _needs_grad(params) if grad is None else grad))


def _kernel_tables(params: MaternParams, device, dtype, grad: bool):
    """(value table, dual table, ``SecondRows``) of the process pairs in
    pair order, built with torch on ``device`` from the parameters' values;
    the last two None unless ``grad``."""
    from cokriging_tpu_torch.kernels.cuda_ops import recurrence_table

    nu_pairs, ls_pairs = (t.detach().to(device) for t in _pair_stacks(params))
    value = recurrence_table(nu_pairs, ls_pairs, dtype)
    if not grad:
        return value, None, None
    return (value, recurrence_table(nu_pairs, ls_pairs, dtype, order=1),
            SecondRows(nu_pairs, ls_pairs, dtype))


class _MaternCorrPairs(torch.autograd.Function):
    """Matern correlation over gathered entries with per-pair cotangents
    only (the reference's ``_matern_corr_pairs_cvjp``,
    cokriging_tpu/cov/matern.py:479-505): the forward is the gathered-pairs
    kernel, the backward its gradient kernel, which sums ct dM/dnu and
    ct dM/dls per pair; ``idx_f`` and ``h`` are data and get none. On the
    CPU both are their plain versions."""

    @staticmethod
    def forward(ctx, nu_pairs, ls_pairs, idx_f, h, value=None, dual=None):
        from cokriging_tpu_torch.kernels import cuda_ops

        ctx.save_for_backward(nu_pairs, ls_pairs, idx_f, h)
        ctx.dual = dual
        return cuda_ops.matern_corr_pairs(nu_pairs.detach(), ls_pairs.detach(), idx_f, h,
                                          table=value)

    @staticmethod
    def backward(ctx, ct):
        from cokriging_tpu_torch.kernels import cuda_ops

        nu_pairs, ls_pairs, idx_f, h = ctx.saved_tensors
        g = cuda_ops.matern_corr_pairs_grad(nu_pairs, ls_pairs, idx_f, h, ct, table=ctx.dual)
        return g[:, 0].to(nu_pairs.dtype), g[:, 1].to(ls_pairs.dtype), None, None, None, None


def matern_corr_pairs(nu_pairs, ls_pairs, idx_f, h, table=None):
    """Matern correlation over gathered entries whose (nu, len_scale) take
    one of ``n_pairs`` values, selected per entry by the float index plane
    ``idx_f`` (0.0 .. n_pairs - 1.0; any other value selects pair 0).

    Where nothing will differentiate it, this is the registered op
    ``kernels.cuda_ops.matern_corr_pairs``: the gathered-pairs kernel on a
    CUDA tensor, the plain version on the CPU (the path that the live
    predictors and a program traced by ``torch.export`` share). Under
    autograd, on a CUDA tensor it is ``_MaternCorrPairs``: the kernel
    forward and, when ``nu_pairs`` or ``ls_pairs`` require grad, its
    gradient kernel backward (h gets no gradient there); on the CPU the
    plain per-entry select through the elementwise ``matern_correlation``
    under ordinary autograd, which is what the reference runs off the TPU.
    ``table``: a ``PairTable`` holding the kernels' tables of these pairs,
    or None to build them per launch (the dual one also where the
    ``PairTable`` has none).
    """
    from cokriging_tpu_torch.kernels import cuda_ops

    h = torch.as_tensor(h)
    nu_pairs = torch.as_tensor(nu_pairs, device=h.device)
    ls_pairs = torch.as_tensor(ls_pairs, device=h.device)
    tables = (None, None) if table is None else (table.value, table.dual)
    if not (torch.is_grad_enabled()
            and (nu_pairs.requires_grad or ls_pairs.requires_grad or h.requires_grad)):
        return cuda_ops.matern_corr_pairs(nu_pairs, ls_pairs, idx_f, h, table=tables[0])
    if not h.is_cuda:
        return cuda_ops.matern_corr_pairs_plain(nu_pairs, ls_pairs, idx_f, h)
    if h.requires_grad:
        raise ValueError("matern_corr_pairs: the kernels on the card give h no gradient")
    return _MaternCorrPairs.apply(nu_pairs, ls_pairs, idx_f, h, *tables)


def _pair_terms(params, pa, pb):
    """(amplitude, nugget) of every entry's process pair (pa, pb):
    sigma_a^2 and tau_a^2 on same-process entries, rho_ab sigma_a sigma_b
    and 0 across. One ``torch.where`` per process pair, so the backward sums
    each pair's cotangent; gathering the (p,)-sized parameters by per-entry
    index would scatter every entry's cotangent into p slots instead."""
    p = params.n_procs
    sig = params.sigma
    amp = nug = 0.0
    for i in range(p):
        for j in range(p):
            sel = (pa == i) & (pb == j)
            if i == j:
                amp = torch.where(sel, sig[i] ** 2, amp)
                nug = torch.where(sel, params.nugget[i], nug)
            else:
                amp = torch.where(sel, params.rho[i, j] * sig[i] * sig[j], amp)
    return amp, nug


def gathered_covariance(params: MaternParams, d, procs_a, procs_b=None, table=None):
    """Pointwise mixed-process covariance from gathered process ids.

    Entry (a, b) applies the reference's conventions to the process pair
    (procs_a[a], procs_b[b]) at distance d[a, b]: sigma_i^2 M_ii for same-
    process pairs with the nugget on exact-zero distances, and
    rho_ij sigma_i sigma_j M_ij across processes (src/model.py:193-207).
    Shared by the matrix-free CG matvec (``predict.iterative``) and the
    direct-assembly local predictor (``predict.local``,
    ``materialize_cov=False``); broadcasts over leading batch dimensions.
    The correlations go through ``matern_corr_pairs``. ``table``: the
    ``pair_table`` of these parameters' values for ``d``, or None to build
    it here.
    """
    d = torch.as_tensor(d)
    if procs_b is None:
        procs_b = procs_a
    if table is None:
        table = pair_table(params, d.device, d.dtype)
    pa = torch.as_tensor(procs_a, device=d.device).long()[..., :, None]
    pb = torch.as_tensor(procs_b, device=d.device).long()[..., None, :]
    nu_pairs, ls_pairs = _pair_stacks(params)
    idx = torch.broadcast_to(table.index[pa, pb], d.shape).to(d.dtype).contiguous()
    corr = matern_corr_pairs(nu_pairs, ls_pairs, idx, d, table)
    amp, nugget = _pair_terms(params, pa, pb)
    return amp * corr + torch.where(d == 0.0, nugget, 0.0)


def windows_covariance(params: MaternParams, d, procs, mvar=None, table=None):
    """Batched mixed-process covariance over symmetric gathered windows.

    The per-entry conventions of ``gathered_covariance``, specialized to a
    batch of square symmetric distance windows (..., w, w), the Vecchia
    term layout (``estimate.vecchia``): only the lower triangle of each
    window (``torch.tril_indices``, made on the device) goes through
    ``matern_corr_pairs``, and is mirrored as low + low^T - low * I.

    Args:
        params: MaternParams for p processes.
        d: (..., w, w) symmetric per-window distance matrices.
        procs: (..., w) int process ids of each window slot.
        mvar: optional (..., w) per-slot measurement-error variances added
            to the window diagonals.
        table: the ``pair_table`` of these parameters' values for ``d``,
            or None to build it here.

    Returns:
        (..., w, w) covariance windows.
    """
    d = torch.as_tensor(d)
    w = d.shape[-1]
    if table is None:
        table = pair_table(params, d.device, d.dtype)
    nu_pairs, ls_pairs = _pair_stacks(params)
    procs = torch.as_tensor(procs, device=d.device).long()
    pa = procs[..., :, None]
    pb = procs[..., None, :]
    idx = table.index[pa, pb]
    ti, tj = torch.tril_indices(w, w, device=d.device)
    corr_t = matern_corr_pairs(nu_pairs, ls_pairs, idx[..., ti, tj].to(d.dtype), d[..., ti, tj],
                               table)
    low = torch.zeros(d.shape, dtype=corr_t.dtype, device=d.device)
    low[..., ti, tj] = corr_t  # its backward gathers, where a mirroring gather would scatter
    eye = torch.eye(w, dtype=d.dtype, device=d.device)
    corr = low + low.transpose(-1, -2) - low * eye
    amp, nugget = _pair_terms(params, pa, pb)
    cov = amp * corr + torch.where(d == 0.0, nugget, 0.0)
    if mvar is not None:
        cov = cov + mvar[..., None] * eye
    return cov


class MultivariateMatern:
    """OO surface mirroring the reference model class (src/model.py:173-317),
    delegating to the module functions."""

    def __init__(self, n_procs: int = None, params: MaternParams = None) -> None:
        if n_procs is None:
            n_procs = params.n_procs if params is not None else 2
        self.n_procs = n_procs
        self.params = params if params is not None else MaternParams.default(n_procs)
        if self.params.n_procs != n_procs:
            raise ValueError(
                f"params are for {self.params.n_procs} processes, "
                f"n_procs={n_procs} requested."
            )
        self.fit_result = None

    def correlation(self, i, j, h):
        return correlation(self.params, i, j, h)

    def covariance(self, i, h, use_nugget: bool = True):
        return covariance(self.params, i, h, use_nugget=use_nugget)

    def cross_covariance(self, i, j, h):
        return cross_covariance(self.params, i, j, h)

    def semivariance(self, i, h):
        return semivariance(self.params, i, h)

    def cross_semivariance(self, i, j, h):
        return cross_semivariance(self.params, i, j, h)

    def set_values(self, x):
        self.params = self.params.with_flat(torch.as_tensor(x))
        return self

    def get_values(self):
        return np.asarray(self.params.to_flat().detach().cpu())

    def variograms(self, h, kind: str = "semivariogram"):
        """Theoretical variogram curves for all i <= j pairs as a pandas
        frame (index (i, j, idx), columns distance/variogram), matching
        src/model.py:239-247. ``h`` is evaluated on the parameters' device
        in their dtype."""
        import pandas as pd

        cov = kind == "covariogram"
        h_np = np.asarray(h)
        h_t = torch.as_tensor(h_np, dtype=self.params.sigma.dtype, device=self.params.sigma.device)
        frames = []
        with torch.no_grad():
            for i in range(self.n_procs):
                for j in range(i, self.n_procs):
                    v = variogram_value(self.params, i, j, h_t, covariogram=cov).cpu().numpy()
                    df = pd.DataFrame({"distance": h_np, "variogram": v, "i": i, "j": j})
                    frames.append(df.set_index(["i", "j", df.index]))
        return pd.concat(frames)

    def fit(self, estimate, guess: MaternParams = None, method: str = "scipy", device=None):
        """Composite-WLS fit to an EmpiricalVariogram on ``device`` (the card
        unless ``device="cpu"``); see ``estimate.wls.fit_wls``."""
        from cokriging_tpu_torch.estimate.wls import fit_wls

        self.params, self.fit_result = fit_wls(
            estimate, self.params if guess is None else guess, method=method, device=device
        )
        return self
