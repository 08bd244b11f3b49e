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
``kernels.cuda_ops.matern_block_grad`` backward.
"""

import math

import numpy as np
import torch

from cokriging_tpu_torch.cov.params import MaternParams
from cokriging_tpu_torch.kernels.bessel import kv

_LN2 = math.log(2.0)


def matern_correlation(nu, len_scale, h):
    r"""Matern correlation :math:`\rho(h)` in log space (src/model.py:354-385).

    .. math::
        \rho(h) = \frac{2^{1-\nu}}{\Gamma(\nu)}
                  (\sqrt{2\nu} h/\ell)^{\nu} K_\nu(\sqrt{2\nu} h/\ell)

    Elementwise over broadcast ``nu``, ``len_scale`` and ``h``;
    differentiable in all three.
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
    log_pref = (1.0 - nu) * _LN2 - torch.lgamma(nu) + nu * torch.log(arg)
    corr = torch.exp(log_pref) * kv(nu, arg)
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


class _ScaledMaternBlock(torch.autograd.Function):
    """One covariance block C = scale * M(nu, ls, h) + nugget * [h == 0]
    with scalar-only cotangents (the reference's ``_make_scaled_cvjp``,
    cokriging_tpu/cov/matern.py:180-293): the backward returns the four
    scalar gradients and none for ``h``, which is data. On a CUDA tensor the
    forward is the Matern kernel and the backward the block-gradient kernel;
    on the CPU both are their plain versions. ``symmetric`` (marginal
    self-distance blocks) lets both evaluate the lower triangle only."""

    @staticmethod
    def forward(ctx, scale, nugget, nu, ls, h, symmetric):
        from cokriging_tpu_torch.kernels.cuda_ops import matern_correlation_block

        ctx.save_for_backward(scale, nugget, nu, ls, h)
        ctx.symmetric = symmetric
        out = matern_correlation_block(nu.detach(), ls.detach(), h, symmetric=symmetric)
        out.mul_(scale)
        return out.add_(torch.where(h == 0.0, nugget.to(out.dtype), 0.0))

    @staticmethod
    def backward(ctx, ct):
        from cokriging_tpu_torch.kernels.cuda_ops import matern_block_grad

        scale, nugget, nu, ls, h = ctx.saved_tensors
        g = matern_block_grad(scale, nugget, nu, ls, h, ct.to(h.dtype), ctx.symmetric)
        return (g[0].to(scale.dtype), g[1].to(nugget.dtype), g[2].to(nu.dtype),
                g[3].to(ls.dtype), None, None)


def block_covariance(params: MaternParams, dists, h_grad: bool = True):
    """Assemble the joint block covariance for p processes.

    ``dists[i][j]`` is the (n_i, n_j) distance matrix between the
    observation sets of processes i and j; only i <= j entries are read
    (lower blocks are transposes, src/joint_prediction.py:124-153). Marginal
    blocks are self-distance matrices, symmetric by construction, so the
    kernels evaluate their lower triangle only.

    On a CUDA tensor every block, float32 or float64, goes through the
    hand-written kernels: ``matern_correlation_block`` forward and, when a
    parameter requires grad, ``matern_block_grad`` backward
    (``_ScaledMaternBlock``); the distances get no gradient there. On the
    CPU, ``h_grad=True`` differentiates the plain elementwise model (in the
    distances too), and ``h_grad=False`` (distances are data) takes the
    same block Function with the kernels' plain versions.
    """
    from cokriging_tpu_torch.kernels.cuda_ops import matern_correlation_block

    p = params.n_procs
    on_card = torch.as_tensor(dists[0][0]).is_cuda
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad
        for t in (params.sigma, params.nu, params.len_scale, params.nugget, params.rho)
    )
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
            if needs_grad and (on_card or not h_grad):
                blocks[(i, j)] = _ScaledMaternBlock.apply(
                    scale, nugget, params.nu[i, j], params.len_scale[i, j], h, i == j
                )
                continue
            m = matern_correlation_block(
                params.nu[i, j], params.len_scale[i, j], h, symmetric=(i == j)
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
