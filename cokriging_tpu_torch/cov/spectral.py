r"""Matern spectral densities and the spectral validity of the bivariate model.

Counterpart of ``cokriging_tpu/cov/spectral.py:20-199`` (the reference's
spectral analysis, research/matern_spectrum.ipynb cells 7-14). The
d-dimensional isotropic spectral density of the unit-variance Matern
correlation in the Rasmussen-Williams parameterization is

    f(w) = C_d(nu, ell) * (2 nu / ell^2 + 4 pi^2 w^2)^-(nu + d/2)

with the normalization that integrates back to 1 (Stein 1999, R&W 2006
ch. 4). ``rho_max`` and ``project_to_valid`` hold a fitted model to the
Gneiting, Kleiber & Schlather (2010) validity bound. These are host-side
utilities on a few scalars: they compute in float64 on the CPU whatever
the parameters' dtype and device, and hand results back in them.
``bessel_j0`` and ``spectral_correlation_roundtrip`` (the spectral density
integrated back to a correlation) are the self-consistency check of the
densities.
"""

import dataclasses
import math

import numpy as np
import torch

_F64 = torch.float64


def _f64(v):
    return torch.as_tensor(v, dtype=_F64, device="cpu").detach()


def _log_spectral_density_unit(w, nu, len_scale, d):
    """log of the unit-variance Matern spectral density (stable for the
    validity-bound ratios, where the densities under/overflow)."""
    log_c = (
        d * math.log(2.0)
        + 0.5 * d * math.log(math.pi)
        + torch.lgamma(nu + 0.5 * d)
        + nu * torch.log(2.0 * nu)
        - torch.lgamma(nu)
        - 2.0 * nu * torch.log(len_scale)
    )
    base = 2.0 * nu / len_scale**2 + 4.0 * math.pi**2 * w**2
    return log_c - (nu + 0.5 * d) * torch.log(base)


def matern_spectral_density(w, nu, len_scale, sigma2=1.0, d=2):
    r"""Isotropic R&W Matern spectral density in d dimensions (float64).

    S(w) = sigma2 * 2^d pi^{d/2} Gamma(nu + d/2) (2 nu)^nu /
           (Gamma(nu) ell^{2 nu}) * (2 nu / ell^2 + 4 pi^2 |w|^2)^{-(nu+d/2)}

    (Rasmussen & Williams 2006, eq. 4.15 adapted to frequency w in cycles.)
    """
    log_s = _log_spectral_density_unit(_f64(w), _f64(nu), _f64(len_scale), d)
    return _f64(sigma2) * torch.exp(log_s)


def matern_spectral_density_1d(w, nu, len_scale, sigma2=1.0):
    """1-d marginal spectral density (for line-transect checks)."""
    return matern_spectral_density(w, nu, len_scale, sigma2, d=1)


def classic_to_rw_len_scale(classic_scale, nu):
    """The 'classic' Matern range parameter (kappa = 1/scale inside
    K_nu(kappa h)) as the R&W length scale ell = sqrt(2 nu) * scale."""
    return torch.sqrt(2.0 * _f64(nu)) * classic_scale


def rw_to_classic_len_scale(len_scale, nu):
    return len_scale / torch.sqrt(2.0 * _f64(nu))


def rho_max(nu1, l1, nu2, l2, nu12, l12, d=2, n_freq=2048):
    r"""Exact validity bound on |rho| for the full bivariate Matern.

    Gneiting, Kleiber & Schlather (2010), Thm 3: the model is a valid
    bivariate covariance iff rho^2 S12(w)^2 <= S11(w) S22(w) for all
    frequencies w, with S_ij the unit-variance Matern spectral densities at
    (nu_ij, ell_ij). This evaluates the infimum of sqrt(S11 S22) / S12 on a
    wide log frequency grid plus w = 0, in log space and in float64. The
    w -> infinity tail goes like w^{2 (2 nu12 - nu1 - nu2)}: below the floor
    nu12 < (nu1 + nu2) / 2 no rho != 0 is valid (bound 0). The floor test's
    tolerance keys off the dtype the nus arrived in, so a parsimonious nu12
    = (nu1 + nu2) / 2 computed in float32 is not read as below it.

    Returns the bound clipped to [0, 1] as a float64 CPU scalar tensor.
    """
    def eps_of(v):
        if isinstance(v, torch.Tensor):
            return torch.finfo(v.dtype if v.is_floating_point() else _F64).eps
        dt = np.asarray(v).dtype
        return float(np.finfo(dt if dt.kind == "f" else np.float64).eps)

    in_eps = max(eps_of(v) for v in (nu1, nu2, nu12))
    nu1, l1, nu2, l2, nu12, l12 = (_f64(v) for v in (nu1, l1, nu2, l2, nu12, l12))
    l_ref = torch.minimum(torch.minimum(l1, l2), l12)
    w = torch.cat([torch.zeros(1, dtype=_F64),
                   torch.logspace(-8.0, 8.0, n_freq, dtype=_F64) / l_ref])
    log_ratio = (
        _log_spectral_density_unit(w, nu1, l1, d)
        + _log_spectral_density_unit(w, nu2, l2, d)
        - 2.0 * _log_spectral_density_unit(w, nu12, l12, d)
    )
    min_log = torch.min(log_ratio)
    tail_exp = 2.0 * nu12 - nu1 - nu2
    tol = 100.0 * in_eps * (nu1 + nu2)
    min_log = torch.where(tail_exp < -tol, -math.inf, min_log)
    return torch.clamp(torch.exp(0.5 * min_log), 0.0, 1.0)


def params_rho_max(params, i: int, j: int, d=2):
    """Validity bound for the (i, j) pair of a MaternParams."""
    return rho_max(
        params.nu[i, i], params.len_scale[i, i],
        params.nu[j, j], params.len_scale[j, j],
        params.nu[i, j], params.len_scale[i, j],
        d=d,
    )


def _set_sym(m, i, j, v):
    """Copy of matrix ``m`` with entries (i, j) and (j, i) set to ``v``."""
    m = m.clone()
    m[i, j] = v
    m[j, i] = v
    return m


def project_to_valid(params, margin: float = 0.99, d=2, lift_nu: bool = True,
                     parsimony: bool = False):
    """Project a fitted MaternParams onto the spectral validity region.

    Both moves keep the marginal structure exactly:

    1. if ``lift_nu`` and a cross-smoothness sits below the Gneiting floor
       nu_ij < (nu_ii + nu_jj) / 2, where no nonzero rho is valid, raise it
       to the floor (the parsimonious choice, Gneiting et al. 2010 §3);
    2. clip every cross-correlation to +/- margin * rho_max.

    ``parsimony=True`` snaps the cross-structure onto the parsimonious
    bivariate Matern: nu_ij = (nu_ii + nu_jj) / 2 from both directions and
    len_scale_ij = sqrt(len_scale_ii len_scale_jj), which keeps the
    admissible region of rho wide. The result keeps the parameters' dtype
    and device; rho is clipped in float64 and cast back, as the reference
    does.
    """
    p = params.n_procs
    nu = params.nu
    if lift_nu or parsimony:
        for i in range(p):
            for j in range(i + 1, p):
                floor = 0.5 * (params.nu[i, i] + params.nu[j, j])
                v = floor if parsimony else torch.maximum(params.nu[i, j], floor)
                nu = _set_sym(nu, i, j, v)
        params = dataclasses.replace(params, nu=nu)
    if parsimony:
        ls = params.len_scale
        for i in range(p):
            for j in range(i + 1, p):
                v = torch.sqrt(params.len_scale[i, i] * params.len_scale[j, j])
                ls = _set_sym(ls, i, j, v)
        params = dataclasses.replace(params, len_scale=ls)
    rho = params.rho
    for i in range(p):
        for j in range(i + 1, p):
            bound = margin * float(params_rho_max(params, i, j, d=d))
            r = torch.clamp(params.rho[i, j].to(_F64), -bound, bound).to(rho.dtype)
            rho = _set_sym(rho, i, j, r)
    return dataclasses.replace(params, rho=rho)


def bessel_j0(x):
    """J_0(x), Bessel function of the first kind, order zero, in float64 on
    the host.

    Abramowitz & Stegun 9.4.1 (|x| < 8, rational polynomial) and 9.4.3
    (|x| >= 8, modulus/phase asymptotic); ~1e-8 absolute accuracy, plenty
    for the spectral round-trip quadrature, whose discretization error
    dominates.
    """
    x = torch.abs(_f64(x))
    # |x| < 8: rational P(y)/Q(y) in y = x^2
    y = x * x
    p_small = (
        57568490574.0
        + y * (-13362590354.0 + y * (651619640.7
        + y * (-11214424.18 + y * (77392.33017 + y * (-184.9052456)))))
    )
    q_small = (
        57568490411.0
        + y * (1029532985.0 + y * (9494680.718
        + y * (59272.64853 + y * (267.8532712 + y))))
    )
    small = p_small / q_small
    # |x| >= 8: modulus-phase form
    ax = torch.clamp_min(x, 1e-30)
    z = 8.0 / ax
    y2 = z * z
    xx = ax - 0.785398164
    p1 = (
        1.0
        + y2 * (-0.1098628627e-2 + y2 * (0.2734510407e-4
        + y2 * (-0.2073370639e-5 + y2 * 0.2093887211e-6)))
    )
    p2 = (
        -0.1562499995e-1
        + y2 * (0.1430488765e-3 + y2 * (-0.6911147651e-5
        + y2 * (0.7621095161e-6 + y2 * (-0.934935152e-7))))
    )
    large = torch.sqrt(0.636619772 / ax) * (torch.cos(xx) * p1 - z * torch.sin(xx) * p2)
    return torch.where(x < 8.0, small, large)


def spectral_correlation_roundtrip(nu, len_scale, h, n_freq=4096, w_max=None, d=1):
    """Numerically invert the d-dimensional spectral density back to a
    correlation and evaluate it at lags h (float64, host), the
    self-consistency check of the notebook's spectral/covariance comparisons
    (research/matern_spectrum.ipynb cells 7-14). d=1 is the cosine-transform
    pair; d=2 the Hankel transform

        C(h) = 2 pi * int_0^inf S(w) J_0(2 pi w h) w dw.
    """
    if d not in (1, 2):
        raise NotImplementedError("roundtrip check implemented for d in (1, 2)")
    if w_max is None:
        w_max = 40.0 / len_scale
    w = torch.linspace(0.0, float(w_max), n_freq, dtype=_F64)
    s = matern_spectral_density(w, nu, len_scale, d=d)
    h = torch.atleast_1d(_f64(h))
    if d == 1:
        # C(h) = 2 * int_0^inf S(w) cos(2 pi w h) dw  (even spectrum)
        integrand = s[None, :] * torch.cos(2.0 * math.pi * w[None, :] * h[:, None])
        return 2.0 * torch.trapezoid(integrand, w, dim=1)
    integrand = s[None, :] * bessel_j0(2.0 * math.pi * w[None, :] * h[:, None]) * w[None, :]
    return 2.0 * math.pi * torch.trapezoid(integrand, w, dim=1)
