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

from cokriging_tpu_torch.cov.matern import matern_correlation
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
    """(|C_ij(h)|, sqrt(C_ii(h) C_jj(h))) of every pair i < j, nugget-free.
    ``params`` may carry a leading batch shape (``MaternParams.from_flat``
    of a (..., n_params) stack); ``h`` is (..., n_h) then."""
    p = params.n_procs
    sig = params.sigma[..., None]

    def corr(i, j):
        return matern_correlation(params.nu[..., i, j, None], params.len_scale[..., i, j, None], h)

    return [
        (torch.abs(params.rho[..., i, j, None] * sig[..., i, :] * sig[..., j, :] * corr(i, j)),
         torch.sqrt(sig[..., i, :] ** 2 * corr(i, i) * (sig[..., j, :] ** 2 * corr(j, j))))
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
    live; zero inside the valid region, so it never biases a valid fit.
    With batched ``params`` (batch shape S) and centers of shape S + (...),
    one penalty per member."""
    batch = params.sigma.shape[:-1]
    h = torch.linspace(0.0, 1.0, n_h, dtype=centers.dtype, device=centers.device) * (
        centers.reshape(*batch, -1).amax(-1)[..., None])
    total = torch.zeros(batch, dtype=h.dtype, device=h.device)
    for c, r in _cs_terms(params, h):
        total = total + torch.sum(torch.clamp_min(c - r, 0.0) ** 2, dim=-1)
    return total


def _flat_positions(pairs, spec: ParamSpec) -> np.ndarray:
    """(7, n_pairs) positions in the flat vector of sigma_i, sigma_j,
    nugget_i, nugget_j, nu_ij, len_scale_ij and rho_ij of every pair (rho's
    row holds 0 for a marginal pair, where it is not read)."""
    p = spec.n_procs
    t = p * (p + 1) // 2
    iu = [(i, j) for i in range(p) for j in range(p) if i <= j]
    iu1 = [(i, j) for i in range(p) for j in range(p) if i < j]
    return np.array([
        [i for i, _ in pairs], [j for _, j in pairs],
        [p + 2 * t + i for i, _ in pairs], [p + 2 * t + j for _, j in pairs],
        [p + iu.index((i, j)) for i, j in pairs], [p + t + iu.index((i, j)) for i, j in pairs],
        [2 * p + 2 * t + iu1.index((i, j)) if i < j else 0 for i, j in pairs],
    ])


def _ordered_sum(x):
    """Sum over the last axis, added in order: one member's sum takes the
    same operations whatever else is in the batch (a reduction kernel's
    order can depend on the number of rows)."""
    parts = x.unbind(-1)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def composite_wls_cost(flat, centers, means, counts, pairs, spec: ParamSpec):
    """Composite WLS cost over stacked (n_pairs, n_bins) bin tensors.

    Rows align to ``pairs``. Bins with zero count, NaN mean, or zero model
    value are excluded. Marginal and cross groups both reduce to
    fit = A - B * M(nu, ls, h), so all pairs share one Matern evaluation.
    A leading batch shape (flat (..., n_params), the bins (..., n_pairs,
    n_bins)) gives one cost per member. Every parameter is gathered to the
    bins' full shape and the bins are added in order, so no step reduces
    across broadcast axes: a member's cost and gradient take the same
    operations alone and in any batch.
    """
    dev = flat.device
    n_pairs, n_bins = centers.shape[-2:]
    pos = torch.as_tensor(_flat_positions(pairs, spec), device=dev)[:, :, None].expand(
        7, n_pairs, n_bins)
    si, sj, ni, nj, nu, ls, rho = (flat[..., pos[k]] for k in range(7))
    marginal = torch.as_tensor([i == j for i, j in pairs], device=dev)[:, None]
    sill = 0.5 * (si**2 + ni + sj**2 + nj)
    a_coef = torch.where(marginal, si**2 + ni, sill)
    b_coef = torch.where(marginal, si**2, rho * si * sj)
    fit = a_coef - b_coef * matern_correlation(nu, ls, centers)
    valid = (counts > 0) & torch.isfinite(means) & (fit != 0.0)
    fit_safe = torch.where(fit == 0.0, 1.0, fit)
    r = (means - fit_safe) / fit_safe
    return _ordered_sum(torch.where(valid, counts * r * r, 0.0).flatten(-2))


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
    # 1 / (1 + exp(-u)), not torch.sigmoid: the CPU's vectorized sigmoid
    # rounds otherwise than its scalar tail, so a member's value would
    # depend on its place in a batch
    return lo + (hi - lo) / (1.0 + torch.exp(-u))


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
        fitter = make_device_adam_fitter(tuple(pairs), spec, maxiter,
                                         validity_weight=validity_weight)
        x, cost = fitter(torch.as_tensor(x0, dtype=dt, device=dev), centers, means, counts)
        params = MaternParams.from_flat(x, spec=spec)
        cost, n_iter = float(cost), maxiter
        success = bool(np.isfinite(cost))
    elif method == "lbfgs":
        fitter = make_device_wls_fitter(tuple(pairs), spec, maxiter)
        x, cost, n_iter, success = fitter(torch.as_tensor(x0, dtype=dt, device=dev), centers,
                                          means, counts)
        params = MaternParams.from_flat(x, spec=spec)
        cost, n_iter = float(cost), int(n_iter)
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


def _wls_objective(pairs, spec, validity_weight, centers, means, counts):
    """x (..., n_params) -> the composite WLS cost of each member, plus
    ``validity_weight`` times its total pair count times its
    ``validity_penalty``."""

    def objective(x):
        cost = composite_wls_cost(x, centers, means, counts, pairs, spec)
        if validity_weight:
            cost = cost + validity_weight * torch.sum(counts, dim=(-2, -1)) * validity_penalty(
                MaternParams.from_flat(x, spec=spec), centers)
        return cost

    return objective


def make_device_adam_fitter(pairs, spec, maxiter=800, lr=0.3, validity_weight=0.0):
    """Adam with a cosine-decayed learning rate under the sigmoid box
    transform (``adam_cosine``), in the estimate's dtype on its device.

    Returns fit(x0, centers, means, counts) -> (x, cost). With a leading
    batch axis (x0 (B, n_params), the bins (B, n_pairs, n_bins)) every
    member takes its own steps in the same launches: Adam's update is
    elementwise and each member's gradient is its own, so each equals its
    fit alone. ``lr`` is the schedule peak.
    """
    lo_np, hi_np = spec.bounds()

    def fit(x0, centers, means, counts):
        dt, dev = centers.dtype, centers.device
        lo = torch.as_tensor(lo_np, dtype=dt, device=dev)
        hi = torch.as_tensor(hi_np, dtype=dt, device=dev)
        raw = _wls_objective(pairs, spec, validity_weight, centers, means, counts)

        def objective(u):
            return raw(_box_forward(u, lo, hi))

        u0 = _box_inverse(torch.as_tensor(x0, dtype=dt, device=dev), lo, hi)
        u = adam_cosine(lambda u: objective(u).sum(), u0, maxiter, lr=lr)
        with torch.no_grad():
            return _box_forward(u, lo, hi), objective(u)

    return fit


def make_device_wls_fitter(pairs, spec, maxiter=300, validity_weight=0.0):
    """Bounded L-BFGS fitter on the estimate's device:
    (x0, centers, means, counts) -> (x, cost, n_evals, converged).

    ``estimate.nll.sigmoid_box_lbfgs_batch`` from 3 deterministic starts
    (WLS cost surfaces are multimodal: a secondary basin ~100x above the
    optimum catches default and moment inits on oracle problems). With a
    leading batch axis (x0 (B, n_params), the bins (B, n_pairs, n_bins))
    all B x 3 members step together, one cost evaluation per iteration for
    all of them, and each member's result is its fit alone.

    ``validity_weight`` adds the Cauchy-Schwarz ``validity_penalty``
    (scaled by the total pair count): thin monthly estimates otherwise
    minimize at |rho| = 1, where the joint model is singular.
    """
    from cokriging_tpu_torch.estimate.nll import sigmoid_box_lbfgs_batch

    lo_np, hi_np = spec.bounds()

    def fit(x0, centers, means, counts):
        dt, dev = centers.dtype, centers.device
        single = centers.ndim == 2
        x0 = torch.as_tensor(x0, dtype=dt, device=dev)
        if single:
            x0, centers, means, counts = x0[None], centers[None], means[None], counts[None]

        def raw(x, rows):
            return _wls_objective(pairs, spec, validity_weight, centers[rows], means[rows],
                                  counts[rows])(x)

        out = sigmoid_box_lbfgs_batch(
            raw, x0, torch.as_tensor(lo_np, dtype=dt, device=dev),
            torch.as_tensor(hi_np, dtype=dt, device=dev), maxiter=maxiter, n_starts=3,
        )
        return tuple(o[0] for o in out) if single else out

    return fit


def fit_wls_batch(
    estimates,
    init: Optional[MaternParams] = None,
    maxiter: int = 300,
    mesh=None,
    validity_weight: float = 0.0,
    per_month_init: bool = False,
    project_validity=False,
    device=None,
):
    """Fit many months or bands at once: the batched L-BFGS fitter
    (``make_device_wls_fitter``) over all of them on ``device`` (the card
    unless ``device="cpu"``), in the dtype of their bin centers.

    Args:
        estimates: list of EmpiricalVariogram with identical pairs/n_bins.
        init: shared initial MaternParams (also fixes spec/bounds).
        mesh: not supported yet (a device mesh is ROADMAP.md Queue 1 item
            8); anything but None raises.
        validity_weight: Cauchy-Schwarz penalty weight (see
            ``make_device_wls_fitter``).
        per_month_init: start each month from its own ``moment_init``
            instead of the shared ``init``.
        project_validity: project each fitted month onto the spectral
            validity region (``cov.spectral.project_to_valid``): ``True``
            lifts the cross smoothness to the Gneiting floor and clips rho to
            its bound; ``"parsimony"`` also snaps the cross structure onto
            the parsimonious bivariate Matern.

    Returns:
        (list of MaternParams, costs ndarray, converged bool ndarray), all
        in estimate order.
    """
    if not estimates:
        return [], np.zeros(0)
    pairs = tuple(estimates[0].pairs)
    init = init or MaternParams.default(estimates[0].config.n_procs)
    spec = init.spec
    centers = np.stack([e.bin_centers for e in estimates])
    # zero-count bins are excluded by the cost mask; NaN means zeroed here
    means = np.nan_to_num(np.stack([e.bin_means for e in estimates]), nan=0.0)
    counts = np.stack([e.bin_counts for e in estimates])
    if per_month_init:
        x0 = np.stack([moment_init(e, spec=spec).to_flat().numpy() for e in estimates])
    else:
        x0 = np.tile(init.to_flat().detach().cpu().numpy()[None], (len(estimates), 1))
    xs, costs, conv = fit_wls_batch_arrays(
        x0, centers, means, counts, pairs, spec, maxiter=maxiter, mesh=mesh,
        validity_weight=validity_weight, device=device,
    )
    dev = resolve_device(device)
    params_list = [MaternParams.from_flat(torch.as_tensor(x, device=dev), spec=spec) for x in xs]
    if project_validity:
        from cokriging_tpu_torch.cov.spectral import project_to_valid

        parsimony = project_validity == "parsimony"
        params_list = [project_to_valid(p, parsimony=parsimony) for p in params_list]
    return params_list, costs, conv


def fit_wls_batch_arrays(
    x0, centers, means, counts, pairs, spec, maxiter: int = 300, mesh=None,
    validity_weight: float = 0.0, device=None,
):
    """Array-level core of ``fit_wls_batch`` and the engine of the
    parametric bootstrap (``estimate.bootstrap``): the batched L-BFGS over
    (centers, means, counts) stacks on ``device`` (the card unless
    ``device="cpu"``), in the dtype of ``centers``.

    Args:
        x0: (B, n_params) initial flat vectors.
        centers/means/counts: (B, n_pairs, n_bins) stacks (means must be
            NaN-free; zero-count bins are masked by the cost).
        mesh: not supported yet (ROADMAP.md Queue 1 item 8); anything but
            None raises.

    Returns:
        (xs, costs, converged): (B, n_params) fitted flats, (B,) final
        costs, (B,) bool convergence flags, as numpy arrays.
    """
    if mesh is not None:
        raise ValueError("mesh= is not ported yet (ROADMAP.md Queue 1 item 8)")
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(centers), device=dev)
    fitter = make_device_wls_fitter(tuple(pairs), spec, maxiter, validity_weight=validity_weight)
    xs, costs, _, conv = fitter(
        torch.as_tensor(np.asarray(x0), dtype=c.dtype, device=dev), c,
        torch.as_tensor(np.asarray(means), dtype=c.dtype, device=dev),
        torch.as_tensor(np.asarray(counts), device=dev).to(c.dtype),
    )
    return xs.cpu().numpy(), costs.cpu().numpy(), conv.cpu().numpy()
