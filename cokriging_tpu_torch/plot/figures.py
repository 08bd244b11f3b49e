"""Diagnostic and reporting figures.

Counterpart of ``cokriging_tpu/plot/figures.py``, with the reference's
plotting layer (src/plot.py): CONUS maps, residual-field panels,
empirical-vs-fitted variogram grids, simulation panels, error-ratio maps,
LOOCV diagnostics (with MSPE/MAPE), climatologies, and monthly GIF
animations (the reference's notebooks/1degree_monthly_animations
[.variance].ipynb workflows). cartopy is not used: maps render on plain
lon/lat axes with the coastline polygons of ``data.landmask`` as context
(``coastlines=False`` turns them off).

The figures take the port's objects (``MultiField``, ``FitResult``,
``BivariateRandomField``), the predictors' ``LocalPrediction`` results and
pandas frames, and move tensors to the host themselves.
"""

from typing import List, Optional

import matplotlib.pyplot as plt
import numpy as np
import pandas as pd


def _host(t) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _frame(pred) -> pd.DataFrame:
    """A prediction as a frame: a ``LocalPrediction`` through its
    ``to_dataframe``, a frame as it is."""
    return pred if isinstance(pred, pd.DataFrame) else pred.to_dataframe()


def _add_coastlines(ax):
    from cokriging_tpu_torch.data.landmask import _MAINLAND, _WATER

    for poly, lw in [(_MAINLAND, 0.6)] + [(w, 0.5) for w in _WATER]:
        v = np.array(list(poly) + [poly[0]])
        ax.plot(v[:, 0], v[:, 1], color="0.4", lw=lw, zorder=3)


def plot_df(
    df: pd.DataFrame,
    column: str,
    title: str = "",
    extents=(-125, -65, 22, 58),
    cmap: str = "viridis",
    ax=None,
    coastlines: bool = True,
    **kwargs,
):
    """Scatter a lat/lon frame column on a CONUS map
    (reference plot_df, src/plot.py:147-179)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))
    sc = ax.scatter(
        df["lon"], df["lat"], c=df[column], s=kwargs.pop("s", 12),
        cmap=cmap, marker="s", **kwargs
    )
    plt.colorbar(sc, ax=ax, shrink=0.8, label=column)
    if coastlines:
        _add_coastlines(ax)
    ax.set_xlim(extents[0], extents[1])
    ax.set_ylim(extents[2], extents[3])
    ax.set_xlabel("lon")
    ax.set_ylabel("lat")
    ax.set_title(title)
    return ax


def plot_da(grid_df: pd.DataFrame, column: str, **kwargs):
    """Gridded-field map; same rendering as plot_df for long-format frames
    (reference plot_da, src/plot.py:117-144)."""
    return plot_df(grid_df, column, **kwargs)


def plot_fields(mf, titles: Optional[List[str]] = None, coastlines=True):
    """Side-by-side standardized residual fields of a MultiField
    (reference plot_fields, src/plot.py:335-370)."""
    n = mf.n_procs
    fig, axes = plt.subplots(1, n, figsize=(7 * n, 4.5), squeeze=False)
    for k, f in enumerate(mf.fields):
        ax = axes[0][k]
        df = f.to_dataframe()
        c1, c2 = df.columns[0], df.columns[1]
        sc = ax.scatter(df[c2], df[c1], c=df[f.name], s=14, cmap="RdBu_r", marker="s")
        plt.colorbar(sc, ax=ax, shrink=0.8)
        if f.geodesic and coastlines:
            _add_coastlines(ax)
        ax.set_title(titles[k] if titles else f"{f.name} @ {f.timestamp}")
    return fig


def plot_variograms(
    fit_result,
    kind: str = "Semivariogram",
    names: Optional[List[str]] = None,
):
    """Empirical points + fitted curves for all (i, j) groups
    (reference plot_variograms, src/plot.py:425-471)."""
    emp = fit_result.estimate.df
    theo = fit_result.df_theoretical
    pairs = fit_result.estimate.pairs
    n = len(pairs)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 4), squeeze=False)
    for k, (i, j) in enumerate(pairs):
        ax = axes[0][k]
        e = emp.loc[(i, j)]
        t = theo.loc[(i, j)]
        ax.scatter(e["bin_center"], e["bin_mean"], s=18, color="k", label="empirical")
        ax.plot(t["distance"], t["variogram"], color="C3", label="fitted")
        label = (
            f"{kind} {names[i]}" if (names and i == j) else
            f"Cross-{kind.lower()} {names[i]}:{names[j]}" if names else f"({i},{j})"
        )
        ax.set_title(label)
        ax.set_xlabel("separation distance")
        ax.legend()
    fig.suptitle(f"WLS cost: {fit_result.cost:.4g}")
    return fig


def plot_samples(samples: List[pd.DataFrame], titles=("Z0", "Z1")):
    """Sampled cofield panels (reference plot_samples, src/plot.py:30-58)."""
    fig, axes = plt.subplots(1, len(samples), figsize=(11, 4.5), squeeze=False)
    for k, s in enumerate(samples):
        ax = axes[0][k]
        sc = ax.scatter(s["x"], s["y"], c=s[f"Z{k}"], s=16, cmap="RdBu_r")
        plt.colorbar(sc, ax=ax, shrink=0.8)
        ax.set_title(titles[k])
    return fig


def plot_sim_pred(rf, df_pred, i: int = 0):
    """Truth vs prediction vs error panels on the simulation grid
    (reference plot_sim_pred, src/plot.py:61-90). ``df_pred``: a frame or a
    ``LocalPrediction`` with x/y coordinates."""
    df_pred = _frame(df_pred)
    truth = rf.fields[i]
    # merge on rounded keys: float32 predictions carry float32 coordinates,
    # which a raw float join against the grid's float64 coordinates matches
    # only where they are exact; 6 - ceil(log10(|coord|)) decimals absorb
    # the float32 error (~7 significant digits) at any coordinate magnitude
    span = max(
        1.0,
        float(np.nanmax(np.abs(truth["x"].to_numpy(dtype="float64")))),
        float(np.nanmax(np.abs(truth["y"].to_numpy(dtype="float64")))),
    )
    decimals = max(0, 6 - int(np.ceil(np.log10(span))))

    def _k(d):
        # round in float64: .round on a float32 column stays float32
        return d.assign(
            _kx=d["x"].astype("float64").round(decimals),
            _ky=d["y"].astype("float64").round(decimals),
        )

    merged = _k(df_pred).merge(
        _k(truth)[["_kx", "_ky", "value"]], on=["_kx", "_ky"], how="left"
    ).drop(columns=["_kx", "_ky"])
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, col, cmap, title in zip(
        axes,
        ["value", "pred", "pred_err"],
        ["RdBu_r", "RdBu_r", "magma"],
        [f"truth Z{i}", "prediction", "prediction error"],
    ):
        sc = ax.scatter(merged["x"], merged["y"], c=merged[col], s=14, cmap=cmap)
        plt.colorbar(sc, ax=ax, shrink=0.8)
        ax.set_title(title)
    return fig


def plot_err_ratio(df_biv, df_uni, coords=("x", "y"), coastlines=False):
    """Map of cokriging / kriging prediction-error ratio
    (reference plot_err_ratio, src/plot.py:474-521). Frames or
    ``LocalPrediction`` results."""
    c1, c2 = coords
    merged = _frame(df_biv).merge(_frame(df_uni), on=[c1, c2], suffixes=("_biv", "_uni"))
    merged["err_ratio"] = merged["pred_err_biv"] / merged["pred_err_uni"]
    fig, ax = plt.subplots(figsize=(7, 5))
    sc = ax.scatter(
        merged[c2 if c1 == "lat" else c1],
        merged[c1 if c1 == "lat" else c2],
        c=merged["err_ratio"],
        s=16,
        cmap="PuOr",
        vmin=2 - merged["err_ratio"].max(),
        vmax=merged["err_ratio"].max(),
    )
    plt.colorbar(sc, ax=ax, shrink=0.85, label="error ratio (cokriging / kriging)")
    if coastlines:
        _add_coastlines(ax)
    frac = float((merged["err_ratio"] < 1).mean())
    ax.set_title(f"error ratio < 1 at {100 * frac:.1f}% of locations")
    return fig


def plot_cv_resid(df_cv: pd.DataFrame, name: str = ""):
    """LOOCV residual diagnostics with MSPE/MAPE annotation
    (reference plot_cv_resid, src/plot.py:524-538); ``df_cv`` a LOOCV frame
    (``cross_validation(..., postprocess=True)``)."""
    resid = df_cv["residual"].dropna().values
    mspe = float(np.mean(resid**2))
    mape = float(np.mean(np.abs(resid)))
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].hist(resid, bins=30, color="C0", alpha=0.8)
    axes[0].set_title(f"{name} LOOCV residuals | MSPE {mspe:.4g}, MAPE {mape:.4g}")
    std = df_cv["residual"] / df_cv["pred_err"]
    axes[1].hist(std.replace([np.inf, -np.inf], np.nan).dropna(), bins=30, color="C1", alpha=0.8)
    axes[1].set_title("standardized residuals")
    return fig


def raw_climatology(df: pd.DataFrame, columns: List[str]):
    """Domain-average raw climatology lines (src/plot.py:195-225)."""
    fig, ax = plt.subplots(figsize=(9, 4))
    for c in columns:
        ax.plot(df["time"], df[c], label=c)
    ax.legend()
    ax.set_title("raw climatology")
    return fig


def resid_climatology(df: pd.DataFrame, columns: List[str]):
    """Detrended climatology lines (src/plot.py:228-258). The series are
    the frame's host columns; their detrend runs on the host."""
    from cokriging_tpu_torch.stats import detrend

    fig, ax = plt.subplots(figsize=(9, 4))
    for c in columns:
        resid, _ = detrend(df[c].values.astype(float), device="cpu")
        ax.plot(df["time"], resid, label=f"{c} resid")
    ax.legend()
    ax.set_title("residual climatology")
    return fig


def resid_coord_avg(mf):
    """Residual averages by latitude and by longitude per field (the
    reference's resid_coord_avg, src/plot.py:261-322, on the current
    MultiField API)."""
    n = mf.n_procs
    fig, axes = plt.subplots(2, n, figsize=(5 * n, 7), squeeze=False)
    for k, f in enumerate(mf.fields):
        df = f.to_dataframe()
        c1, c2 = df.columns[0], df.columns[1]
        by1 = df.groupby(c1)[f.name].mean()
        by2 = df.groupby(c2)[f.name].mean()
        axes[0][k].plot(by1.index, by1.values, marker="o", ms=3)
        axes[0][k].set_title(f"{f.name}: mean residual by {c1}")
        axes[1][k].plot(by2.index, by2.values, marker="o", ms=3, color="C1")
        axes[1][k].set_title(f"{f.name}: mean residual by {c2}")
    return fig


def qq_plots(mf):
    """Normal Q-Q plots of each field's standardized residuals
    (reference qq_plots, src/plot.py:182-193, on the current MultiField
    API)."""
    import scipy.stats as st

    n = mf.n_procs
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 4), squeeze=False)
    for k, f in enumerate(mf.fields):
        st.probplot(_host(f.values), dist="norm", plot=axes[0][k])
        axes[0][k].set_title(f.name)
    return fig


def animate_monthly(
    df: pd.DataFrame,
    column: str,
    time_col: str = "time",
    out_path: Optional[str] = None,
    extents=None,
    cmap: str = "RdYlGn",
    vcenter: Optional[float] = None,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    fps: int = 2,
    coastlines: bool = True,
    s: float = 12,
    title: str = "",
):
    """Animate a gridded long-format field month by month (reference
    notebooks/1degree_monthly_animations.ipynb and
    1degree_monthly_animations_variance.ipynb: monthly-mean and per-cell
    variance maps as FuncAnimation frames over a fixed diverging color
    scale, ``colors.TwoSlopeNorm``).

    ``df`` holds one row per (cell, month) with lon/lat/``time_col``/
    ``column``. The color scale is fixed across frames, so frames compare;
    unset limits default to data quantiles. Writes an animated GIF when
    ``out_path`` is given and returns the ``FuncAnimation`` either way
    (keep a reference alive until saved).
    """
    from matplotlib import colors
    from matplotlib.animation import FuncAnimation, PillowWriter

    # one groupby instead of a scan per frame; NaT groups are dropped
    groups = {k: g for k, g in df.groupby(time_col) if pd.notna(k)}
    frames = sorted(groups)
    if not frames:
        raise ValueError("animate_monthly: no time frames in dataframe")
    if vmin is None:
        vmin = float(np.nanquantile(df[column], 0.02))
    if vmax is None:
        vmax = float(np.nanquantile(df[column], 0.98))
    if vmax <= vmin:
        vmax = vmin + 1e-6
    if vcenter is not None and vmin < vcenter < vmax:
        norm = colors.TwoSlopeNorm(vcenter=vcenter, vmin=vmin, vmax=vmax)
    else:
        norm = colors.Normalize(vmin=vmin, vmax=vmax)
    if extents is None:
        extents = (
            df["lon"].min() - 2, df["lon"].max() + 2,
            df["lat"].min() - 2, df["lat"].max() + 2,
        )

    fig, ax = plt.subplots(figsize=(10, 5.5))
    cbar_holder = {}

    def draw(k):
        ax.clear()
        sub = groups[frames[k]]
        sc = ax.scatter(
            sub["lon"], sub["lat"], c=sub[column], s=s, marker="s",
            cmap=cmap, norm=norm,
        )
        if "cbar" not in cbar_holder:
            cbar_holder["cbar"] = fig.colorbar(
                sc, ax=ax, shrink=0.8, extend="both", label=column
            )
        if coastlines:
            _add_coastlines(ax)
        ax.set_xlim(extents[0], extents[1])
        ax.set_ylim(extents[2], extents[3])
        stamp = pd.Timestamp(frames[k])
        ax.set_title(f"{title or column} — {stamp:%Y-%m}")
        return ()

    anim = FuncAnimation(fig, draw, frames=len(frames), blit=False)
    if out_path is not None:
        anim.save(out_path, writer=PillowWriter(fps=fps))
        plt.close(fig)
    return anim
