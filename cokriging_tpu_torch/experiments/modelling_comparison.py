"""Kriging against cokriging of SIF on the CONUS land grid.

Counterpart of ``examples/modelling_comparison.py``, with its synthesizer,
its stages, their names and its returned dict:

1. univariate SIF model: fit a Matern to SIF's residual semivariogram
   (``fit_wls``, Adam) and krige SIF onto the 0.5-degree CONUS land grid
   with the ``evi`` covariate;
2. bivariate XCO2 + SIF model: fit the full bivariate Matern (timedeltas
   [0, -1]: SIF one month behind XCO2) and cokrige SIF onto the same grid;
3. compare: the error-ratio frame (cokriging variance over kriging
   variance) and LOOCV MSPE / MAPE of both models.

The data are synthetic at the shape of the augmented-CONUS pipeline:
monthly long-format frames on the 4 x 5-degree main grid whose residuals
are a joint bivariate-Matern draw with rho = -0.6 (``TRUE_FLAT``), linear
trends in time, an EVI covariate surface for SIF and sparser SIF coverage.
The draw is the JAX script's: numpy's generator in its order, the joint
covariance assembled by ``joint_covariance_from_coords`` in the run's dtype
(float32 on the card through the Matern kernel, float64 on the CPU), then
one float64 host Cholesky.

Every stage runs on ``device`` (the card unless ``device="cpu"``) in the
run's dtype. ``stage_s`` holds each stage's first run; ``stage_warm_s``
times each compute stage once more. JAX's repeat reuses a compiled
program; the port compiles nothing, so on the card the repeat is a second
eager run of the same launches. ``JAX_MANIFEST`` holds the JAX package's
own run (``results/modelling_comparison.json``) for ``compare_manifest``.

Sizes: ``CARD_SIZES`` on the card (the JAX script's), ``CPU_SIZES`` on the
CPU (the JAX test's); keyword arguments of ``main`` override them. The
manifest ``torch_modelling_comparison.json`` and, where matplotlib is
installed, the figures ``torch_comparison_*.png`` go through
``utils.results`` (``COKRIGING_RESULTS_DIR`` and ``COKRIGING_NO_RECORD``
apply).

    python -m cokriging_tpu_torch.experiments.modelling_comparison [--device cuda|cpu]
"""

import argparse
import importlib.util

import numpy as np
import torch

from cokriging_tpu_torch.experiments import Stages, resolve_sizes

TRUE_FLAT = [1.0, 0.8, 1.5, 1.5, 1.5, 700.0, 700.0, 700.0, 0.02, 0.02, -0.6]

#: the script's sizes on the card and (the JAX test's) on the CPU
CARD_SIZES = dict(months=6, pred_stride=1, maxiter=600)
CPU_SIZES = dict(months=6, pred_stride=6, maxiter=250)

#: the JAX package's run on a TPU (results/modelling_comparison.json)
JAX_MANIFEST = {
    "timestamp": "2019-05-01",
    "n_pred_cells": 6256,
    "mspe": {"kriging": 0.0449, "cokriging": 0.0337},
    "mape": {"kriging": 0.1731, "cokriging": 0.1498},
    "err_ratio_lt1_frac": 1.0,
    "params_biv_flat": [0.9922, 0.9472, 3.2821, 3.1692, 3.4312, 611.8988, 462.0983, 769.7608,
                        0.0611, 0.172, -0.3477],
    "warm_wall_s": 11.6,
    "wall_total_s": 275.5,
}


def _evi_surface(lat, lon):
    """Deterministic stand-in for the 0.5-degree MODIS EVI covariate."""
    return (
        0.35
        + 0.15 * np.cos(np.deg2rad(lat) * 4.0)
        + 0.08 * np.sin(np.deg2rad(lon) * 3.0)
    )


def synthesize_conus_months(seed=0, months=6, sif_coverage=0.55, device=None):
    """Monthly XCO2 + SIF frames on the 4 x 5-degree CONUS main grid whose
    residuals are a joint bivariate-Matern draw with rho = -0.6. SIF at
    month k-1 carries the second member of month k's draw (the
    timedeltas=[0, -1] mechanism). The joint covariance is assembled on
    ``device`` (the card unless ``device="cpu"``) in its dtype
    (``compute_dtype``), the rest on the host in float64. Returns
    (df_xco2, df_sif)."""
    import pandas as pd

    from cokriging_tpu_torch.cov.matern import joint_covariance_from_coords
    from cokriging_tpu_torch.cov.params import MaternParams
    from cokriging_tpu_torch.data.grids import main_coords_array
    from cokriging_tpu_torch.utils.config import compute_dtype, resolve_device

    dev = resolve_device(device)
    dtype = compute_dtype(dev)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    coords = main_coords_array().astype(np_dtype)
    lat, lon = coords[:, 0].astype(np.float64), coords[:, 1].astype(np.float64)
    n = len(coords)
    truth = MaternParams.from_flat(torch.tensor(TRUE_FLAT, dtype=dtype, device=dev))
    c = torch.as_tensor(coords, device=dev)
    with torch.no_grad():
        jc = joint_covariance_from_coords(truth, [c, c], True).cpu().numpy().astype(np.float64)
    # jitter sized to the covariance dtype's rounding
    jit_eps = 1e-9 if np_dtype == np.float64 else 1e-5
    chol = np.linalg.cholesky(jc + jit_eps * np.eye(2 * n))

    times = pd.date_range("2019-01-01", periods=months + 1, freq="MS")
    evi = _evi_surface(lat, lon)
    rows_x, rows_s = [], []
    for k in range(months + 1):
        z = chol @ rng.normal(size=2 * n)
        z0, z1 = z[:n], z[n:]
        # XCO2 at month k: temporal trend + lon/lat surface + GP residual
        xco2 = 400.0 + 0.12 * k + 0.02 * lat - 0.01 * lon + z0
        xco2 += rng.normal(scale=0.05, size=n)
        rows_x.append(pd.DataFrame({"time": times[k], "lat": lat, "lon": lon, "xco2": xco2,
                                    "xco2_var": 0.01}))
        # SIF at month k-1 carries the Z1 member of month k's joint draw
        if k >= 1:
            sif = 0.6 + 0.01 * (k - 1) + 1.2 * evi + 0.5 * z1
            sif += rng.normal(scale=0.04, size=n)
            keep = rng.random(n) < sif_coverage
            sif = np.where(keep, sif, np.nan)
            rows_s.append(pd.DataFrame({"time": times[k - 1], "lat": lat, "lon": lon,
                                        "sif": sif, "sif_var": 0.01, "evi": evi}))
    return pd.concat(rows_x, ignore_index=True), pd.concat(rows_s, ignore_index=True)


def prediction_frame(pred_stride=1):
    """The 0.5-degree land cells (every ``pred_stride``-th) as a lat/lon
    frame, and the same frame with the ``evi`` covariate: (pcoords,
    cov_pred)."""
    import pandas as pd

    from cokriging_tpu_torch.data.grids import prediction_coords

    pcoords = pd.DataFrame(prediction_coords(), columns=["lat", "lon"]).iloc[::pred_stride]
    cov_pred = pcoords.copy()
    cov_pred["evi"] = _evi_surface(cov_pred["lat"].values, cov_pred["lon"].values)
    return pcoords, cov_pred


def run_comparison(
    seed=0,
    months=6,
    timestamp="2019-05-01",
    sif_coverage=0.55,
    max_dist=1.0e3,
    pred_stride=1,
    maxiter=600,
    df_xco2=None,
    df_sif=None,
    device=None,
    stages=None,
):
    """Fit univariate-SIF and bivariate-XCO2+SIF models on the same month
    and predict the same 0.5-degree grid with both, on ``device`` (the card
    unless ``device="cpu"``). ``stages``: a ``Stages`` on that device (its
    entries ``<stage>`` and ``<stage>_warm``), or None for a new one.
    Returns a dict with prediction frames, LOOCV frames, the merged
    error-ratio frame, the score frame, the fitted parameter sets and fit
    results, and the stage seconds (``stage_s``; ``stage_warm_s`` for the
    compute stages' second run, an eager re-run of the same launches)."""
    import pandas as pd

    from cokriging_tpu_torch.cov.matern import MultivariateMatern
    from cokriging_tpu_torch.data.grids import main_coords_array
    from cokriging_tpu_torch.estimate.empirical import VarioConfig, empirical_variograms
    from cokriging_tpu_torch.estimate.wls import fit_wls, moment_init
    from cokriging_tpu_torch.fields.field import MultiField, apply_timedelta
    from cokriging_tpu_torch.predict.local import LocalPredictor
    from cokriging_tpu_torch.utils.config import compute_dtype, resolve_device

    dev = resolve_device(device)
    dtype = compute_dtype(dev)
    stages = stages or Stages(dev)
    stage_s, stage_warm_s = {}, {}

    def _stage(name, fn):
        out = fn()
        stages(name)
        stage_s[name] = stages.seconds[name]
        return out

    def _stage_warm(name, fn):
        out = _stage(name, fn)
        fn()
        stages(name + "_warm")
        stage_warm_s[name] = stages.seconds[name + "_warm"]
        return out

    if df_xco2 is None or df_sif is None:
        df_xco2, df_sif = _stage("synthesize", lambda: synthesize_conus_months(
            seed=seed, months=months, sif_coverage=sif_coverage, device=dev))
    main = main_coords_array()
    month_sif = apply_timedelta(timestamp, -1)
    pcoords, cov_pred = prediction_frame(pred_stride)
    stages.skip()

    # ---- univariate SIF kriging ----
    mf_uni = _stage("fields_uni", lambda: MultiField.from_dataframes(
        [df_sif], ["sif"], [["evi"]], timestamp=month_sif, timedeltas=[0],
        main_coords=main).astype(dtype))
    est_uni = _stage("variogram_uni", lambda: empirical_variograms(
        mf_uni, VarioConfig(max_dist=1.5e3, n_bins=15, n_procs=1), device=dev))
    params_uni, fit_uni = _stage_warm("fit_uni", lambda: fit_wls(
        est_uni, init=moment_init(est_uni), method="adam", maxiter=maxiter, device=dev))
    krig = _stage("predictor_uni", lambda: LocalPredictor(
        MultivariateMatern(1, params_uni.astype(dtype)), mf_uni, covariates=cov_pred, device=dev))
    df_krig = _stage_warm("predict_uni", lambda: krig(0, pcoords, max_dist=max_dist))
    cv_krig = _stage_warm("loocv_uni", lambda: krig.cross_validation(0, max_dist=max_dist))

    # ---- bivariate XCO2+SIF cokriging ----
    mf_biv = _stage("fields_biv", lambda: MultiField.from_dataframes(
        [df_xco2, df_sif], ["xco2", "sif"], [["lon", "lat"], ["evi"]], timestamp=timestamp,
        timedeltas=[0, -1], main_coords=main).astype(dtype))
    est_biv = _stage("variogram_biv", lambda: empirical_variograms(
        mf_biv, VarioConfig(max_dist=1.5e3, n_bins=15, n_procs=2), device=dev))
    params_biv, fit_biv = _stage_warm("fit_biv", lambda: fit_wls(
        est_biv, init=moment_init(est_biv), method="adam", maxiter=maxiter, device=dev))
    cokrig = _stage("predictor_biv", lambda: LocalPredictor(
        MultivariateMatern(2, params_biv.astype(dtype)), mf_biv, covariates=cov_pred, device=dev))
    df_cokrig = _stage_warm("predict_biv", lambda: cokrig(1, pcoords, max_dist=max_dist))
    cv_cokrig = _stage_warm("loocv_biv", lambda: cokrig.cross_validation(1, max_dist=max_dist))

    # ---- error-ratio frame: both frames carry the cells' float64 lat/lon ----
    ratio = df_cokrig.merge(df_krig, on=["lat", "lon"], suffixes=("_cokrig", "_krig"))
    if len(ratio) != len(df_cokrig) or len(df_cokrig) != len(df_krig):
        raise AssertionError(f"the error-ratio merge kept {len(ratio)} of {len(df_cokrig)} / "
                             f"{len(df_krig)} cells")
    ratio["ratio"] = ratio["pred_err_cokrig"] ** 2 / ratio["pred_err_krig"] ** 2

    def _scores(cv):
        r = cv["residual"].dropna()
        return float(np.mean(r**2)), float(np.mean(np.abs(r)))

    mspe_k, mape_k = _scores(cv_krig)
    mspe_c, mape_c = _scores(cv_cokrig)
    scores = pd.DataFrame({"method": ["kriging", "cokriging"], "MSPE": [mspe_k, mspe_c],
                           "MAPE": [mape_k, mape_c]})
    return {
        "df_krig": df_krig,
        "df_cokrig": df_cokrig,
        "cv_krig": cv_krig,
        "cv_cokrig": cv_cokrig,
        "ratio": ratio,
        "scores": scores,
        "params_uni": params_uni,
        "params_biv": params_biv,
        "fit_uni": fit_uni,
        "fit_biv": fit_biv,
        "stage_s": stage_s,
        "stage_warm_s": stage_warm_s,
    }


def sizes_for(device, **sizes) -> dict:
    """The run's sizes on ``device`` (``CARD_SIZES`` on the card,
    ``CPU_SIZES`` on the CPU), then ``sizes``."""
    return resolve_sizes(device, CARD_SIZES, CPU_SIZES, sizes)


def _figures(out):
    """The JAX script's figures, as ``torch_comparison_*``, where
    matplotlib is installed. Returns whether they were written."""
    if importlib.util.find_spec("matplotlib") is None:
        print("figures not written: matplotlib is not installed", flush=True)
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cokriging_tpu_torch.plot import plot_cv_resid, plot_df, plot_err_ratio, plot_variograms
    from cokriging_tpu_torch.utils.results import save_figure

    figs = {
        "torch_comparison_variograms": plot_variograms(out["fit_biv"], names=["xco2", "sif"]),
        "torch_comparison_err_ratio": plot_err_ratio(out["df_cokrig"], out["df_krig"],
                                                     coords=("lat", "lon"), coastlines=True),
        "torch_comparison_cv_kriging": plot_cv_resid(out["cv_krig"], name="Kriging"),
        "torch_comparison_cv_cokriging": plot_cv_resid(out["cv_cokrig"], name="Cokriging"),
    }
    for col in ("pred", "pred_err"):
        figs[f"torch_comparison_cokrig_{col}"] = plot_df(
            out["df_cokrig"].dropna(subset=[col]), col, title=f"SIF cokriging {col}").get_figure()
    for name, fig in figs.items():
        save_figure(fig, name)
        plt.close(fig)
    return True


def main(device=None, stages=None, timestamp="2019-05-01", df_xco2=None, df_sif=None, **sizes):
    """The comparison on ``device`` (the card unless ``device="cpu"``) at
    the script's sizes for that device (``sizes_for``; ``months``,
    ``pred_stride``, ``maxiter`` as keywords), on staged frames where both
    are given. ``stages``: a ``Stages`` on that device, or None for a new
    one. Prints the JAX script's lines, records the manifest and writes
    the figures. Returns the run's record: the manifest's keys (scores,
    error-ratio share, the bivariate fit) plus the stage seconds, launches
    and peak memory (``stage_s``, ``stage_warm_s``, ``launches``,
    ``peak_mib``), ``rho``, the ratio's median, the merged and the finite
    ratio cells and the mean cokriged prediction."""
    import time

    from cokriging_tpu_torch.utils.config import resolve_device
    from cokriging_tpu_torch.utils.results import record_manifest

    dev = resolve_device(device)
    s = sizes_for(dev, **sizes)
    stages = stages or Stages(dev)
    t0 = time.perf_counter()
    out = run_comparison(timestamp=timestamp, df_xco2=df_xco2, df_sif=df_sif, device=dev,
                         stages=stages, **s)
    t_total = time.perf_counter() - t0
    print(f"stage wall-clock (s): {out['stage_s']}  total {t_total:.1f}s")
    print(f"warm execute (s):     {out['stage_warm_s']}")
    print("univariate SIF fit:")
    print(out["params_uni"].to_dataframe().to_string(index=False))
    print("bivariate XCO2+SIF fit:")
    print(out["params_biv"].to_dataframe().to_string(index=False))
    print(out["scores"].to_string(index=False))
    ratio = out["ratio"]["ratio"].dropna()
    frac = float((ratio < 1).mean())
    print(f"error ratio < 1 at {100 * frac:.1f}% of prediction locations", flush=True)

    scores = out["scores"]
    record = {
        "timestamp": timestamp,
        "sizes": s,
        "dtype": str(out["params_biv"].sigma.dtype).removeprefix("torch."),
        "n_pred_cells": int(len(out["df_cokrig"])),
        "n_merged_cells": int(len(out["ratio"])),
        "n_ratio_cells": int(len(ratio)),
        "mspe": {r.method: float(r.MSPE) for r in scores.itertuples()},
        "mape": {r.method: float(r.MAPE) for r in scores.itertuples()},
        "err_ratio_lt1_frac": frac,
        "err_ratio_median": float(ratio.median()),
        "params_uni_flat": out["params_uni"].to_flat().cpu().numpy().astype(np.float64).tolist(),
        "params_biv_flat": out["params_biv"].to_flat().cpu().numpy().astype(np.float64).tolist(),
        "rho": float(out["params_biv"].rho[0, 1]),
        "pred_mean_cokrig": float(out["df_cokrig"]["pred"].dropna().mean()),
        "pred_finite_frac": {k: float(np.isfinite(out[k]["pred"].to_numpy()).mean())
                             for k in ("df_krig", "df_cokrig")},
        "stage_s": out["stage_s"],
        "stage_warm_s": out["stage_warm_s"],
        "warm_wall_s": sum(out["stage_warm_s"].values()) + sum(
            v for k, v in out["stage_s"].items()
            if k not in out["stage_warm_s"] and k != "synthesize"),
        "wall_total_s": t_total,
        "launches": dict(stages.launches),
        "peak_mib": dict(stages.peak_mib),
    }
    record["figures"] = _figures(out)
    record_manifest("torch_modelling_comparison", record)
    return record


def compare_manifest(record):
    """Print the run beside the JAX package's manifest: MSPE and MAPE of
    both methods, the share of cells with a ratio below 1 and the
    bivariate fit's flat vector, each with the difference port - JAX.
    Returns the rows (name, port, JAX, difference)."""
    from cokriging_tpu_torch.cov.params import ParamSpec

    want = JAX_MANIFEST
    rows = [(f"{key} {m}", record[key][m], want[key][m])
            for key in ("mspe", "mape") for m in ("kriging", "cokriging")]
    rows.append(("err_ratio_lt1_frac", record["err_ratio_lt1_frac"], want["err_ratio_lt1_frac"]))
    rows += [(f"biv {nm}", p, j) for nm, p, j in zip(
        ParamSpec(2).names(), record["params_biv_flat"], want["params_biv_flat"])]
    rows = [(name, p, j, float(p) - float(j)) for name, p, j in rows]
    print(f"{'':>22} {'port':>14} {'JAX (TPU)':>14} {'port - JAX':>12}")
    for name, p, j, d in rows:
        print(f"{name:>22} {float(p):14.6g} {float(j):14.6g} {d:+12.4g}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--timestamp", default="2019-05-01")
    ap.add_argument("--sif", default=None, help="staged SIF table (parquet, csv or npz)")
    ap.add_argument("--xco2", default=None, help="staged XCO2 table")
    args = ap.parse_args()
    dfx = dfs = None
    if args.sif and args.xco2:
        from cokriging_tpu_torch.utils.io import load_table

        dfx, dfs = load_table(args.xco2), load_table(args.sif)
    main(args.device, timestamp=args.timestamp, df_xco2=dfx, df_sif=dfs)
