"""Space-time EDA statistics: per-cell detrending and lagged
cross-correlation, as NaN-masked torch reductions over (..., T) tensors.

Counterpart of ``cokriging_tpu/stats/spacetime.py`` (the reference's
src/stat_tools.py). The cell axes are plain batch dimensions, so a whole
lon x lat cube is one pass per lag on the device; the lag search loops over
lags, holding one lag's temporaries at a time.

Masking follows numpy.ma, as the reference does:
- means and sums ignore NaN entries;
- the cross term sums over pairwise-valid entries, each self term over its
  own valid entries (src/stat_tools.py:109-125);
- a ``tau`` threshold NaNs out cells with fewer than tau valid pairs.

Every function takes ``device`` (the card unless ``device="cpu"``) and
computes in float64; arrays come back as numpy.
"""

import numpy as np
import torch

from cokriging_tpu_torch.utils.config import resolve_device


def _cube(x, device):
    """``x`` as a float64 tensor on ``device`` (at least 1-d)."""
    t = torch.as_tensor(np.asarray(x, dtype=np.float64) if not torch.is_tensor(x) else x)
    return torch.atleast_1d(t.to(device=device, dtype=torch.float64))


def _np(t):
    return t.cpu().numpy()


def count_valid(x, axis=-1, device=None):
    """Non-NaN count along the time axis (src/stat_tools.py:9-27)."""
    x = _cube(x, resolve_device(device))
    return _np(torch.isfinite(x).sum(dim=axis).to(torch.float64))


def _linear_fit(x):
    """Masked least-squares line on integer indices: (fitted, slope), fitted
    NaN where x is NaN (src/stat_tools.py:31-53)."""
    t = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    m = torch.isfinite(x)
    w = m.to(x.dtype)
    n = torch.clamp_min(w.sum(-1, keepdim=True), 1.0)
    xm = torch.where(m, x, 0.0)
    tbar = (w * t).sum(-1, keepdim=True) / n
    ybar = xm.sum(-1, keepdim=True) / n
    tc = (t - tbar) * w
    sxx = (tc * tc).sum(-1, keepdim=True)
    sxy = (tc * (xm - ybar * w)).sum(-1, keepdim=True)
    slope = torch.where(sxx > 0, sxy / torch.clamp_min(sxx, 1e-300), 0.0)
    fitted = torch.where(m, ybar + slope * (t - tbar), torch.nan)
    return fitted, slope[..., 0]


def _detrend(x):
    fitted, slope = _linear_fit(x)
    return torch.where(torch.isfinite(x), x - fitted, torch.nan), slope


def simple_linear_regression(x, device=None):
    """Fitted trend line of a 1-d series (src/stat_tools.py:31-53)."""
    return _np(_linear_fit(_cube(x, resolve_device(device)))[0])


def detrend(x, device=None):
    """(residuals, slope) per series along the last axis
    (src/stat_tools.py:56-94), as numpy."""
    resid, slope = _detrend(_cube(x, resolve_device(device)))
    return _np(resid), _np(slope)


def _centered(z1, z2):
    """Both series centered by their own masked means over the full series,
    zero where invalid: (x, m1, y, m2)."""
    m1 = torch.isfinite(z1)
    m2 = torch.isfinite(z2)
    n1 = torch.clamp_min(m1.sum(-1, keepdim=True), 1)
    n2 = torch.clamp_min(m2.sum(-1, keepdim=True), 1)
    x = torch.where(m1, z1, 0.0)
    y = torch.where(m2, z2, 0.0)
    x = torch.where(m1, x - x.sum(-1, keepdim=True) / n1, 0.0)
    y = torch.where(m2, y - y.sum(-1, keepdim=True) / n2, 0.0)
    return x, m1, y, m2


def _shifted(centered, lag):
    """``_centered``'s series with x[t + lag] paired with y[t]."""
    x, m1, y, m2 = centered
    if lag != 0:
        x, m1 = x[..., lag:], m1[..., lag:]
        y, m2 = y[..., :-lag], m2[..., :-lag]
    return x, m1, y, m2


def _xcor_of(centered, lag):
    """Masked lagged cross-correlation along the last axis
    (src/stat_tools.py:98-162) of ``_centered`` series: (xcor,
    pairwise-valid count)."""
    x, m1, y, m2 = _shifted(centered, lag)
    both = m1 & m2
    sxy = torch.where(both, x * y, 0.0).sum(-1)
    sxx = torch.where(m1, x * x, 0.0).sum(-1)
    syy = torch.where(m2, y * y, 0.0).sum(-1)
    denom = torch.sqrt(sxx) * torch.sqrt(syy)
    xcor = torch.where(denom > 0, sxy / torch.clamp_min(denom, 1e-300), torch.nan)
    return xcor, both.sum(-1)


def _xcor_masked(z1, z2, lag):
    return _xcor_of(_centered(z1, z2), lag)


def _xcov_masked(z1, z2, lag):
    """Masked lagged cross-covariance along the last axis, the Cressie-Wikle
    Eq 5.4 estimator (research/analysis_sif_xco2_crosscov.ipynb
    ``compute_xcov_nd``): each series centered by its full-series masked
    mean before the shift, the pairwise-valid products averaged."""
    x, m1, y, m2 = _shifted(_centered(z1, z2), lag)
    both = m1 & m2
    n_pairs = both.sum(-1)
    sxy = torch.where(both, x * y, 0.0).sum(-1)
    return torch.where(n_pairs > 0, sxy / torch.clamp_min(n_pairs, 1), torch.nan), n_pairs


def _scalar(fn, v1, v2, lag, tau, device):
    dev = resolve_device(device)
    val, n = fn(_cube(v1, dev), _cube(v2, dev), int(lag))
    if tau is not None and int(n) < tau:
        return float("nan")
    return float(val)


def _gridded(fn, z1, z2, lag, tau, device):
    dev = resolve_device(device)
    val, n = fn(_cube(z1, dev), _cube(z2, dev), int(lag))
    if tau is not None:
        val = torch.where(n >= tau, val, torch.nan)
    return _np(val)


def xcor_1d(v1, v2, lag=0, tau=None, device=None):
    """Lagged cross-correlation of two 1-d series (src/stat_tools.py:98-125)."""
    return _scalar(_xcor_masked, v1, v2, lag, tau, device)


def xcor_nd(Z1, Z2, lag=0, tau=None, device=None):
    """Gridded lagged cross-correlation over (..., T) cubes
    (src/stat_tools.py:128-162)."""
    return _gridded(_xcor_masked, Z1, Z2, lag, tau, device)


def apply_xcor(Z1, Z2, lag=0, tau=None, device=None):
    """Detrend both cubes, then the lagged cross-correlation
    (src/stat_tools.py:165-178)."""
    dev = resolve_device(device)
    r1, _ = _detrend(_cube(Z1, dev))
    r2, _ = _detrend(_cube(Z2, dev))
    return _gridded(_xcor_masked, r1, r2, lag, tau, dev)


def optim_lag_nd(Z1, Z2, lag_bnds, tau=None, device=None):
    """Per-cell lag maximizing |xcor| over the integer range ``lag_bnds``
    (src/stat_tools.py:181-233): dict(optim_lag, xcor). The detrended and
    centered cubes stay on the device; one lag's temporaries live at a
    time, and the running best is kept per cell (the first lag wins a tie,
    as argmax's first maximum does)."""
    dev = resolve_device(device)
    r1, _ = _detrend(_cube(Z1, dev))
    r2, _ = _detrend(_cube(Z2, dev))
    centered = _centered(r1, r2)  # the same for every lag
    lags = np.arange(*lag_bnds)
    best_score = best_xc = best_lag = None
    for lag in lags:
        xc, n = _xcor_of(centered, int(lag))
        if tau is not None:
            xc = torch.where(n >= tau, xc, torch.nan)
        score = torch.where(torch.isfinite(xc), torch.abs(xc), -torch.inf)
        if best_score is None:
            best_score, best_xc = score, xc
            best_lag = torch.full(score.shape, int(lag), dtype=torch.int64, device=dev)
            continue
        better = score > best_score
        best_score = torch.where(better, score, best_score)
        best_xc = torch.where(better, xc, best_xc)
        best_lag = torch.where(better, int(lag), best_lag)
    return {"optim_lag": _np(best_lag).astype(lags.dtype), "xcor": _np(best_xc)}


def xcov_1d(v1, v2, lag=0, tau=None, device=None):
    """Lagged cross-covariance of two 1-d series
    (research/analysis_sif_xco2_crosscov.ipynb ``compute_xcov_1d``)."""
    return _scalar(_xcov_masked, v1, v2, lag, tau, device)


def xcov_nd(Z1, Z2, lag=0, tau=None, device=None):
    """Gridded lagged cross-covariance over (..., T) cubes
    (research/analysis_sif_xco2_crosscov.ipynb ``compute_xcov_nd``)."""
    return _gridded(_xcov_masked, Z1, Z2, lag, tau, device)


def apply_cross_covariance(Z1, Z2, lag=0, tau=None, device=None):
    """Per-cell lagged cross-covariance map over the whole cube; unlike
    ``apply_xcor`` it does not detrend (the notebook's cells 20, 27, 33)."""
    return xcov_nd(Z1, Z2, lag=lag, tau=tau, device=device)


def optim_lag_1d(v1, v2, lag_bnds, tau=None, device=None):
    """Lag maximizing |xcor| between two 1-d anomaly series over an integer
    range (research/analysis_sif_xco2_crosscov.ipynb cells 12-15):
    dict(optim_lag, xcor). The detrending runs on ``device``; the sweep of
    one short pair over many lags runs on the host, as in the reference."""
    r1, _ = detrend(v1, device)
    r2, _ = detrend(v2, device)
    m1_full, m2_full = np.isfinite(r1), np.isfinite(r2)
    x_full = np.where(m1_full, r1 - np.nanmean(r1), 0.0)
    y_full = np.where(m2_full, r2 - np.nanmean(r2), 0.0)
    best_lag, best_xc = None, float("nan")
    for lag in np.arange(*lag_bnds):
        lag = int(lag)
        if lag == 0:
            x, m1, y, m2 = x_full, m1_full, y_full, m2_full
        else:
            x, m1 = x_full[lag:], m1_full[lag:]
            y, m2 = y_full[:-lag], m2_full[:-lag]
        both = m1 & m2
        if tau is not None and both.sum() < tau:
            continue
        denom = np.sqrt((x[m1] ** 2).sum()) * np.sqrt((y[m2] ** 2).sum())
        if denom <= 0:
            continue
        xc = float((x * y)[both].sum() / denom)
        if np.isfinite(xc) and (best_lag is None or abs(xc) > abs(best_xc)):
            best_lag, best_xc = lag, xc
    return {"optim_lag": best_lag, "xcor": best_xc}


def get_stats(cubes: dict, device=None) -> dict:
    """Counts, slopes and residual standard deviations of each (..., T) cube
    of ``cubes`` (name -> array; src/stat_tools.py:237-247)."""
    dev = resolve_device(device)
    out = {}
    for name, z in cubes.items():
        z = _cube(z, dev)
        out[f"{name}_count"] = _np(torch.isfinite(z).sum(-1).to(torch.float64))
        resid, slope = _detrend(z)
        out[f"{name}_slope"] = _np(slope)
        dev_sq = (resid - torch.nanmean(resid, -1, keepdim=True)) ** 2
        out[f"{name}_std"] = _np(torch.sqrt(torch.nanmean(dev_sq, -1)))
    return out


def get_stats_df(df_group, lags=(0,), tau=None, device=None):
    """Count/slope/std/xcor summary of one grouped frame with sif and xco2
    columns (src/stat_tools.py:250-271)."""
    import pandas as pd

    sif = df_group["sif"].values.astype(float)
    xco2 = df_group["xco2"].values.astype(float)
    sif_resid, sif_slope = detrend(sif, device)
    xco2_resid, xco2_slope = detrend(xco2, device)
    out = pd.DataFrame(
        {
            "sif_count": [np.isfinite(sif).sum()],
            "xco2_count": [np.isfinite(xco2).sum()],
            "sif_slope": [float(sif_slope)],
            "xco2_slope": [float(xco2_slope)],
            "sif_std": [float(np.nanstd(sif_resid))],
            "xco2_std": [float(np.nanstd(xco2_resid))],
        }
    )
    for lag in lags:
        out[f"xcor_lag{lag}"] = xcor_1d(xco2_resid, sif_resid, lag=lag, tau=tau, device=device)
    return out
