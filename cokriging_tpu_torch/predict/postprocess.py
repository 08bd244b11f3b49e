"""Back-transformation of standardized predictions to data scale.

Counterpart of ``cokriging_tpu/predict/postprocess.py``, the reference's
postprocess chain (src/point_prediction.py:251-301, identical in
joint_prediction.py:155-205):

    pred' = pred * scale_fact + spatial_mean
            + OLS-surface(prediction-grid covariates, standardized with the
              fitting-time means/scales)
            + temporal_trend
    err'  = err * scale_fact

``covariates`` supplies the prediction grid's covariate values as a frame
with the coordinate columns plus the field's covariate names; when None, the
coordinates themselves are the covariates (the reference's default,
src/point_prediction.py:263-264). The back-transform runs in float64 numpy
on the host whatever the dtype of the predictions, as ``TrendStats`` is
float64. pandas is imported by the functions, so importing this module
loads none.
"""

import numpy as np


def _host(t) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def postprocess_predictions(df, field, covariates=None):
    """Transform a standardized prediction frame to data scale.

    Args:
        df: frame with coordinate columns (lat/lon or x/y) + pred, pred_err.
        field: the Field predicted (provides TrendStats).
        covariates: optional prediction-grid covariates keyed by the same
            coordinate columns; rows lacking covariates are dropped, as in
            the reference merge (src/point_prediction.py:266-277).
    """
    trend = field.trend
    if trend is None:
        return df.copy()

    out = df.copy()
    out["pred"] = out["pred"].astype(np.float64) * trend.scale_fact + trend.spatial_mean
    out["pred_err"] = out["pred_err"].astype(np.float64) * trend.scale_fact

    coord_cols = [c for c in ("lat", "lon", "x", "y") if c in out.columns]
    if covariates is not None:
        merged = out.merge(covariates, on=coord_cols, how="left")
        keep = ~merged[list(trend.covariate_names)].isna().any(axis=1)
        merged = merged[keep].reset_index(drop=True)
        cov_vals = merged[list(trend.covariate_names)].values.astype(float)
        out = merged[out.columns.tolist()].copy()
    else:
        missing = [c for c in trend.covariate_names if c not in out.columns]
        if missing:
            raise ValueError(
                f"Prediction frame lacks covariate column(s) {missing}; pass"
                " a `covariates` frame."
            )
        cov_vals = out[list(trend.covariate_names)].values.astype(float)

    out["pred"] = out["pred"] + trend.predict_ols(cov_vals)
    out["pred"] = out["pred"] + trend.temporal_trend
    return out


def loocv_frame(field, geodesic, pred, pred_err, postprocess: bool = True):
    """The LOOCV result frame at a field's main-grid locations: columns
    lat/lon (or d1/d2), data, pred, residual, pred_err. With
    ``postprocess`` both data and predictions are back-transformed to data
    units (the reference leaves the data column standardized while
    postprocessing predictions, src/joint_prediction.py:207-257; the JAX
    package does not reproduce that scale mix, nor does this). Shared by the
    local, dense and matrix-free LOOCV paths."""
    import pandas as pd

    data_coords = _host(field.coords_main)
    c1, c2 = ("lat", "lon") if geodesic else ("d1", "d2")
    df = pd.DataFrame(
        {
            c1: data_coords[:, 0],
            c2: data_coords[:, 1],
            "data": _host(field.values_main),
            "pred": _host(pred),
            "pred_err": _host(pred_err),
        }
    )
    if postprocess and field.trend is not None:
        trend = field.trend
        surf = np.asarray(field.spatial_trend_main)
        df["pred"] = (df["pred"].astype(np.float64) * trend.scale_fact + trend.spatial_mean
                      + surf + trend.temporal_trend)
        df["pred_err"] = df["pred_err"].astype(np.float64) * trend.scale_fact
        df["data"] = inverse_transform_data(field)
    df["residual"] = df["data"] - df["pred"]
    return df[[c1, c2, "data", "pred", "residual", "pred_err"]]


def inverse_transform_data(field) -> np.ndarray:
    """A field's standardized main-grid values mapped back to data scale,
    so LOOCV residuals compare like with like."""
    trend = field.trend
    vals = _host(field.values_main)
    if trend is None:
        return vals
    vals = vals.astype(np.float64)
    return (
        vals * trend.scale_fact
        + trend.spatial_mean
        + np.asarray(field.spatial_trend_main)
        + trend.temporal_trend
    )
