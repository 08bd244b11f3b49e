"""Parameter uncertainty of maximum-likelihood fits.

Counterpart of ``cokriging_tpu/estimate/uncertainty.py``. The asymptotic
covariance of the MLE is the inverse of the observed information, the
Hessian of the exact negative log-likelihood at the fitted parameters:

    Cov(theta_hat) ~ I_obs(theta_hat)^-1,   I_obs = d^2 NLL / dtheta^2.

The NLL is ``estimate.nll.neg_log_likelihood(..., analytic_grad=False)``,
differentiated twice by autograd through ``cholesky_ex`` and the triangular
solves. Its covariance blocks are differentiable to second order on every
device: on the card through the block kernels (``cov.matern.
_ScaledMaternBlock``, whose backward ``_ScaledMaternBlockGrad`` has the
second-order kernels of ``kernels/csrc/matern_hess.cu`` as its own
backward), on the CPU through the elementwise model and the twice
differentiable ``kernels.bessel.kv``. The reference takes the same
derivatives (``jax.hessian``, exact AD through its K_nu's custom JVP); its
docstring's "central difference" predates that.

For the WLS estimator see ``estimate/bootstrap.py``.
"""

import warnings
from typing import Optional

import numpy as np
import torch

from cokriging_tpu_torch.cov.params import MaternParams
from cokriging_tpu_torch.estimate.nll import _fit_inputs, neg_log_likelihood
from cokriging_tpu_torch.utils.config import resolve_device


def observed_information(
    params: MaternParams,
    mf,
    use_measurement_var: bool = False,
    jitter: float = 0.0,
    main: bool = True,
    device=None,
) -> np.ndarray:
    """Observed information matrix: the NLL Hessian at ``params``, float64
    numpy, symmetrized as the reference does.

    Evaluated on ``device`` (the card unless ``device="cpu"``) in the dtype
    of the field values, through the plain-AD NLL (``analytic_grad=False``):
    the analytic d(nll)/dC backward bounds memory at large n and defines no
    second order. Memory: besides the graph of the NLL, the Hessian keeps
    each covariance block's tangent partials (three n_i x n_j fields per
    block i <= j, ``matern_block_partials``) until it returns, 2.25 N^2
    values of the field values' dtype for two processes of N / 2
    observations each (11.25 GB at N = 25,000 in float64).
    """
    dev = resolve_device(device)
    _, dists, z, mvar = _fit_inputs(mf, params, use_measurement_var, main, dev)
    spec = params.spec

    def nll_fn(flat):
        return neg_log_likelihood(flat, dists, z, spec, mvar, jitter, analytic_grad=False)

    flat = params.to_flat().detach().to(device=dev, dtype=z.dtype)
    h = torch.autograd.functional.hessian(nll_fn, flat)
    h = h.detach().cpu().numpy().astype(np.float64)
    return 0.5 * (h + h.T)


def nll_std_errors(
    params: MaternParams,
    mf,
    use_measurement_var: bool = False,
    jitter: float = 0.0,
    main: bool = True,
    information: Optional[np.ndarray] = None,
    device=None,
):
    """Asymptotic standard errors and correlations of the MLE.

    Returns ``params.to_dataframe()`` extended with ``std_err`` (sqrt of
    the inverse-information diagonal) and ``at_bound`` (True where the
    estimate lies within 1e-4 of its box's width of a bound: there the
    quadratic approximation, hence the SE, is unreliable). A non-PD
    information matrix falls back to the pseudo-inverse with a warning.
    The parameter covariance and correlation matrices are attached as
    ``df.attrs['covariance']`` and ``df.attrs['correlation']``.
    ``information`` skips the Hessian (for instance one computed on the
    card); otherwise it is computed on ``device``.
    """
    info = (
        observed_information(params, mf, use_measurement_var, jitter, main, device)
        if information is None
        else np.asarray(information, np.float64)
    )
    if np.linalg.eigvalsh(info).min() <= 0:
        warnings.warn(
            "Observed information is not positive definite (parameters are"
            " not at an interior optimum); standard errors use the"
            " pseudo-inverse and may be unreliable."
        )
        cov = np.linalg.pinv(info, hermitian=True)
    else:
        cov = np.linalg.inv(info)
    var = np.diagonal(cov).copy()
    se = np.sqrt(np.maximum(var, 0.0))
    # degenerate directions (var <= 0 under the pseudo-inverse) carry no
    # correlation information
    d = np.where(var > 0, se, np.nan)
    corr = cov / np.outer(d, d)

    lo, hi = params.spec.bounds()
    flat = params.to_flat().detach().cpu().numpy().astype(np.float64)
    tol = 1e-4 * (np.asarray(hi) - np.asarray(lo))
    at_bound = (flat <= np.asarray(lo) + tol) | (flat >= np.asarray(hi) - tol)

    df = params.to_dataframe().copy()
    df["std_err"] = se
    df["at_bound"] = at_bound
    df.attrs["covariance"] = cov
    df.attrs["correlation"] = corr
    return df
