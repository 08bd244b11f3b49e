"""Composite weighted-least-squares variogram fitting.

Counterpart of ``cokriging_tpu/estimate/wls.py``. The cost is Cressie
(1985)'s weighted relative squared error summed over all (i, j) variogram
groups (reference: src/model.py:266-283, 388-391):

    cost = sum over bins with fit != 0 of count * ((emp - fit) / fit)^2

with ``fit`` the semivariogram model at the bin centers. Gradients come
from torch autograd through the Matern/K_nu functions. Three methods:

- ``method='scipy'``: scipy L-BFGS-B under the spec's box bounds;
- ``method='adam'``: Adam with a cosine-decayed learning rate under a
  sigmoid box transform, step for step the reference's
  ``optax.adam(optax.cosine_decay_schedule(lr, maxiter))``. It runs eagerly
  on the fit's device, one objective and one gradient per step;
- ``method='lbfgs'``: ``estimate.nll.sigmoid_box_lbfgs`` on the fit's device
  from three deterministic starts (the reference's ``method='jax'``).

Validity (the reference never enforced it, src/model.py:172, 336-343):
``cauchy_schwarz_check`` tests the necessary Cauchy-Schwarz condition,
``validity_penalty`` is its smooth violation penalty (weighted into the Adam
objective by ``validity_weight``), and ``project_validity=True`` projects the
optimum onto the exact spectral validity region
(``cov.spectral.project_to_valid``).
"""

import math
import warnings
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import covariance, cross_covariance, matern_correlation
from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec
from cokriging_tpu_torch.utils.config import resolve_device


@dataclass
class FitResult:
    """Fitted parameters + diagnostics (reference FittedVariogram,
    src/model.py:320-343)."""

    params: MaternParams
    cost: float
    success: bool
    n_iter: int
    estimate: object = None  # the EmpiricalVariogram fit against
    theoretical: bool = False  # whether df_theoretical is available
    _df_theoretical: object = field(default=None, repr=False)

    @property
    def df_theoretical(self):
        """The theoretical curves on a 100-point grid as a pandas frame
        (src/model.py:330-331), built on the first read; None for a fit run
        with ``theoretical=False``."""
        if self.theoretical and self._df_theoretical is None:
            self._df_theoretical = _theoretical_df(self.params, self.estimate)
        return self._df_theoretical

    @property
    def df_empirical(self):
        return None if self.estimate is None else self.estimate.df

    @property
    def cs_valid(self) -> bool:
        """Cauchy-Schwarz validity of the fitted cross-covariances (the
        check the reference stubbed out, src/model.py:336-343)."""
        return cauchy_schwarz_check(self.params)


def _cs_terms(params: MaternParams, h):
    """(|C_ij(h)|, sqrt(C_ii(h) C_jj(h))) of every pair i < j, nugget-free."""
    p = params.n_procs
    return [
        (torch.abs(cross_covariance(params, i, j, h)),
         torch.sqrt(covariance(params, i, h, use_nugget=False)
                    * covariance(params, j, h, use_nugget=False)))
        for i in range(p) for j in range(i + 1, p)
    ]


def cauchy_schwarz_check(params: MaternParams, n_h: int = 256) -> bool:
    """|C_ij(h)| <= sqrt(C_ii(h) C_jj(h)) for all pairs on an h grid over
    [0, 4 max len_scale], where violations (if any) live: a necessary
    validity condition of the multivariate Matern, implied by the sufficient
    Gneiting et al. (2010) parameter constraints."""
    ls = params.len_scale
    with torch.no_grad():
        h = torch.linspace(0.0, 4.0 * float(torch.max(ls)), n_h, dtype=ls.dtype,
                           device=ls.device)
        return all(bool(torch.all(c <= r + 1e-12)) for c, r in _cs_terms(params, h))


def validity_penalty(params: MaternParams, centers, n_h: int = 96):
    """Smooth Cauchy-Schwarz violation penalty on a dense lag grid from 0
    to the largest fitting lag: sum relu(|C_ij| - sqrt(C_ii C_jj))^2. The
    grid reaches h -> 0, below the smallest bin center, where violations can
    live; zero inside the valid region, so it never biases a valid fit."""
    h = torch.linspace(0.0, 1.0, n_h, dtype=centers.dtype, device=centers.device) * torch.max(
        centers)
    total = torch.zeros((), dtype=h.dtype, device=h.device)
    for c, r in _cs_terms(params, h):
        total = total + torch.sum(torch.clamp_min(c - r, 0.0) ** 2)
    return total


def composite_wls_cost(flat, centers, means, counts, pairs, spec: ParamSpec):
    """Composite WLS cost over stacked (n_pairs, n_bins) bin tensors.

    Rows align to ``pairs``. Bins with zero count, NaN mean, or zero model
    value are excluded. Marginal and cross groups both reduce to
    fit = A - B * M(nu, ls, h), so all pairs share one Matern evaluation.
    """
    params = MaternParams.from_flat(flat, spec=spec)
    dev = flat.device
    ii = torch.as_tensor([i for i, _ in pairs], device=dev)
    jj = torch.as_tensor([j for _, j in pairs], device=dev)
    marginal = ii == jj
    sill = 0.5 * (
        params.sigma[ii] ** 2
        + params.nugget[ii]
        + params.sigma[jj] ** 2
        + params.nugget[jj]
    )
    a_coef = torch.where(marginal, params.sigma[ii] ** 2 + params.nugget[ii], sill)
    b_coef = torch.where(
        marginal,
        params.sigma[ii] ** 2,
        params.rho[ii, jj] * params.sigma[ii] * params.sigma[jj],
    )
    m = matern_correlation(
        params.nu[ii, jj][:, None], params.len_scale[ii, jj][:, None], centers
    )
    fit = a_coef[:, None] - b_coef[:, None] * m
    valid = (counts > 0) & torch.isfinite(means) & (fit != 0.0)
    fit_safe = torch.where(fit == 0.0, 1.0, fit)
    r = (means - fit_safe) / fit_safe
    return torch.sum(torch.where(valid, counts * r * r, 0.0))


def moment_init(estimate, spec: Optional[ParamSpec] = None) -> MaternParams:
    """Method-of-moments initial values from the empirical variograms
    (the reference's ``moment_init``, on the host in float64): sigma^2 +
    tau^2 from the far-field sill, tau^2 from the first bin's intercept, the
    length scale from the 63%-of-sill crossing lag, and rho from the cross
    sill."""
    if spec is None:
        n_procs = 1 + max(j for _, j in estimate.pairs)
        spec = ParamSpec(n_procs=n_procs)
    lo, hi = spec.bounds()
    flat = MaternParams.default(spec.n_procs, spec).to_flat().numpy().copy()
    p = spec.n_procs
    t = p * (p + 1) // 2
    iu = [(i, j) for i in range(p) for j in range(p) if i <= j]

    sills = {}
    for k, (i, j) in enumerate(estimate.pairs):
        centers = np.asarray(estimate.bin_centers[k], float)
        means = np.asarray(estimate.bin_means[k], float)
        good = np.isfinite(means)
        if good.sum() < 3:
            continue
        c, m = centers[good], means[good]
        tail = m[-max(3, len(m) // 3):].mean()
        sills[(i, j)] = tail
        if i == j:
            nug = max(0.0, 2 * m[0] - m[1]) if len(m) > 1 else 0.0
            nug = min(nug, 0.5 * tail)
            sig2 = max(tail - nug, 1e-6)
            target = nug + 0.632 * sig2
            above = np.where(m >= target)[0]
            ell = c[above[0]] if above.size else c[-1]
            flat[i] = np.sqrt(sig2)
            flat[p + t + iu.index((i, i))] = ell
            flat[p + 2 * t + i] = nug
    s = 0
    for i in range(p):
        for j in range(i + 1, p):
            if (i, j) in sills:
                k = estimate.pairs.index((i, j))
                m0 = np.asarray(estimate.bin_means[k], float)
                m0 = m0[np.isfinite(m0)]
                if m0.size:
                    pair_sill = 0.5 * (
                        sills.get((i, i), 1.0) + sills.get((j, j), 1.0)
                    )
                    rho = (pair_sill - m0[0]) / max(flat[i] * flat[j], 1e-6)
                    flat[2 * p + 2 * t + s] = np.clip(rho, -0.9, 0.9)
            ki, kj = iu.index((i, i)), iu.index((j, j))
            kx = iu.index((i, j))
            flat[p + t + kx] = 0.5 * (flat[p + t + ki] + flat[p + t + kj])
            s += 1
    flat = np.clip(flat, lo, hi)
    return MaternParams.from_flat(torch.as_tensor(flat), spec=spec)


def _box_forward(u, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(u)


def _box_inverse(x, lo, hi):
    z = torch.clamp((x - lo) / (hi - lo), 1e-6, 1 - 1e-6)
    return torch.log(z) - torch.log1p(-z)


def adam_cosine(objective, u0, maxiter, lr=0.3, b1=0.9, b2=0.999, eps=1e-8,
                callback=None):
    """``maxiter`` steps of optax's ``adam(cosine_decay_schedule(lr,
    maxiter))`` on ``objective`` from ``u0``; returns the final u.
    ``callback(u, value)`` sees every iterate with its objective value
    before the step that leaves it.

    As in optax: the moments are EMAs in u's dtype, the bias corrections use
    the incremented count (1 - b^(k+1), formed in float64 and cast), the
    learning rate reads the count before the increment,
    lr * 0.5 (1 + cos(pi k / maxiter)), and eps is added outside the root.
    """
    u = u0.detach().clone()
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    for count in range(maxiter):
        u_req = u.requires_grad_(True)
        value = objective(u_req)
        (g,) = torch.autograd.grad(value, u_req)
        u = u_req.detach()
        if callback is not None:
            callback(u, value.detach())
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * (g**2) + b2 * v
        m_hat = m / (1 - b1 ** (count + 1))
        v_hat = v / (1 - b2 ** (count + 1))
        update = m_hat / (torch.sqrt(v_hat) + eps)
        decay = 0.5 * (1 + math.cos(math.pi * min(count, maxiter) / maxiter))
        u = u + (-1 * (lr * decay)) * update
    return u


def fit_wls(
    estimate,
    init: Optional[MaternParams] = None,
    method: str = "scipy",
    maxiter: int = 500,
    validity_weight: float = 0.0,
    theoretical: bool = True,
    project_validity: bool = False,
    device=None,
) -> Tuple[MaternParams, FitResult]:
    """Fit Matern parameters to an EmpiricalVariogram by composite WLS.

    Mirrors MultivariateMatern.fit (src/model.py:285-317): from the default
    (or supplied) initial values, under the spec's box bounds. Runs on
    ``device`` (the card unless ``device="cpu"``) in the dtype of the
    estimate's bin centers; the fitted parameters stay there.

    ``validity_weight`` (``method='adam'``) adds ``validity_weight`` times
    the total pair count times ``validity_penalty`` to the objective.
    ``theoretical=False`` leaves ``FitResult.df_theoretical`` None; with
    True it builds the 100-point theoretical-curve frame on its first read
    (pandas stays off the fit itself). ``project_validity=True`` projects
    the optimum onto the spectral validity region
    (``cov.spectral.project_to_valid``: the cross smoothness lifted to the
    Gneiting floor, rho clipped to 0.99 of its ``rho_max`` bound).
    """
    dev = resolve_device(device)
    spec = (init or MaternParams.default(estimate.config.n_procs)).spec
    if spec.n_procs != estimate.config.n_procs:
        raise ValueError(
            "Number of theoretical processes different from empirical processes."
        )
    init = init or MaternParams.default(spec.n_procs)
    x0 = init.to_flat().detach().cpu().numpy().astype(np.float64)
    centers = torch.as_tensor(np.asarray(estimate.bin_centers), device=dev)
    dt = centers.dtype
    means = torch.as_tensor(np.asarray(estimate.bin_means), device=dev)
    counts = torch.as_tensor(np.asarray(estimate.bin_counts), device=dev).to(dt)
    pairs = tuple(estimate.pairs)

    if method == "scipy":
        from scipy.optimize import minimize

        def fun(x):
            xt = torch.tensor(x, dtype=torch.float64, device=dev, requires_grad=True)
            v = composite_wls_cost(xt, centers, means, counts, pairs, spec)
            (g,) = torch.autograd.grad(v, xt)
            return float(v.detach()), g.cpu().numpy()

        lo, hi = spec.bounds()
        res = minimize(
            fun, x0, jac=True, method="L-BFGS-B",
            bounds=list(zip(lo, hi)), options={"maxiter": maxiter},
        )
        if not res.success:
            warnings.warn("ERROR: optimization did not converge.")
        params = MaternParams.from_flat(
            torch.as_tensor(res.x, dtype=dt, device=dev), spec=spec
        )
        cost, n_iter, success = float(res.fun), int(res.nit), bool(res.success)
    elif method == "adam":
        lo_np, hi_np = spec.bounds()
        lo = torch.as_tensor(lo_np, dtype=dt, device=dev)
        hi = torch.as_tensor(hi_np, dtype=dt, device=dev)

        def objective(u):
            x = _box_forward(u, lo, hi)
            cost = composite_wls_cost(x, centers, means, counts, pairs, spec)
            if validity_weight:
                cost = cost + validity_weight * torch.sum(counts) * validity_penalty(
                    MaternParams.from_flat(x, spec=spec), centers)
            return cost

        u0 = _box_inverse(torch.as_tensor(x0, dtype=dt, device=dev), lo, hi)
        u = adam_cosine(objective, u0, maxiter)
        with torch.no_grad():
            x = _box_forward(u, lo, hi)
            cost = float(objective(u))
        params = MaternParams.from_flat(x, spec=spec)
        n_iter = maxiter
        success = bool(np.isfinite(cost))
    elif method == "lbfgs":
        from cokriging_tpu_torch.estimate.nll import sigmoid_box_lbfgs

        lo_np, hi_np = spec.bounds()
        # 3 deterministic starts: WLS cost surfaces are multimodal (a
        # secondary basin ~100x above the optimum catches default and
        # moment inits on oracle problems)
        x, cost, n_iter, success = sigmoid_box_lbfgs(
            lambda x: composite_wls_cost(x, centers, means, counts, pairs, spec),
            torch.as_tensor(x0, dtype=dt, device=dev),
            torch.as_tensor(lo_np, dtype=dt, device=dev),
            torch.as_tensor(hi_np, dtype=dt, device=dev),
            maxiter=maxiter, n_starts=3,
        )
        params = MaternParams.from_flat(x.detach(), spec=spec)
        cost = float(cost)
        success = bool(success) and bool(np.isfinite(cost))
    else:
        raise ValueError(f"Unknown method {method!r}")

    if project_validity:
        from cokriging_tpu_torch.cov.spectral import project_to_valid

        params = project_to_valid(params)
    return params, FitResult(params=params, cost=cost, success=success, n_iter=n_iter,
                             estimate=estimate, theoretical=theoretical)


def _theoretical_df(params, estimate):
    """Theoretical curves on a 100-point grid in the parameters' dtype
    (src/model.py:330-331)."""
    from cokriging_tpu_torch.cov.matern import MultivariateMatern

    dt = np.dtype(str(params.sigma.dtype).removeprefix("torch."))
    h = np.linspace(0, float(np.max(estimate.bin_centers)), 100, dtype=dt)
    return MultivariateMatern(params.n_procs, params).variograms(h)
