"""Field / MultiField containers with trend removal.

Counterpart of ``cokriging_tpu/fields/field.py``: plain dataclasses over
torch tensors on the host (the entry points move them to their device), built
from arrays (``Field.from_arrays``) or from long-format pandas frames
(columns: time, lat, lon, <name>, <name>_var, covariates...;
``Field.from_dataframe``, ``MultiField.from_dataframes``). The frame path
follows the reference's three-stage residual pipeline (src/fields.py:345-375):

1. remove a linear-in-time trend of the spatial mean series
   (``fit_linear_trend``, src/fields.py:283-287);
2. remove a spatial trend by OLS on standardized covariates (``fit_ols``,
   src/fields.py:290-315), keeping the coefficients and standardization
   stats for prediction-time postprocessing;
3. standardize the residuals by their nanmean/nanstd (src/fields.py:367-373).

All of it runs in float64 numpy, as the reference does; ``astype`` casts the
tensors afterwards, and the inverse-transform statistics (``TrendStats``)
stay float64. pandas is imported only by the functions that take or return
frames.
"""

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class TrendStats:
    """Inverse-transform statistics captured during preprocessing."""

    temporal_trend: float  # trend value at the field's timestamp
    spatial_mean: float
    scale_fact: float
    ols_intercept: float
    ols_coefs: np.ndarray  # on standardized covariates
    covariate_means: np.ndarray
    covariate_scales: np.ndarray
    covariate_names: tuple

    def predict_ols(self, covariates: np.ndarray) -> np.ndarray:
        """Evaluate the spatial-trend surface at raw covariate values."""
        z = (covariates - self.covariate_means) / self.covariate_scales
        return self.ols_intercept + z @ self.ols_coefs


def fit_linear_trend(times_index: np.ndarray, series: np.ndarray) -> np.ndarray:
    """Least-squares linear trend of a series on its integer index,
    evaluated at every index (src/stat_tools.py:31-53). NaNs are excluded
    from the fit; the trend has the series' shape (NaN where it is NaN). A
    record of one epoch gets its mean."""
    out = np.array(series, dtype=float, copy=True)
    good = ~np.isnan(series)
    if good.sum() == 0:
        return out
    x = times_index[good].astype(float)
    y = series[good]
    if np.unique(x).size < 2:
        out[good] = y.mean()
        return out
    slope, intercept = np.polyfit(x, y, 1)
    out[good] = intercept + slope * times_index[good]
    return out


def fit_ols(values: np.ndarray, covariates: np.ndarray):
    """OLS of values on standardized covariates (src/fields.py:290-315).

    Returns (fitted_surface, intercept, coefs, means, scales)."""
    means = covariates.mean(axis=0)
    scales = covariates.std(axis=0, ddof=1)  # pandas .std() default (ddof=1)
    z = (covariates - means) / scales
    X = np.column_stack([np.ones(len(z)), z])
    beta, *_ = np.linalg.lstsq(X, values, rcond=None)
    fitted = X @ beta
    return fitted, beta[0], beta[1:], means, scales


def _coord_isin(coords: np.ndarray, main: np.ndarray) -> np.ndarray:
    """Boolean row-membership of coords in main, both coordinates matched
    after rounding to 9 decimals (the reference's merge on centers,
    src/data_utils.py:315-328), so grids built by linspace and by arange
    agree."""
    view = {(round(a, 9), round(b, 9)) for a, b in main}
    return np.array([(round(a, 9), round(b, 9)) in view for a, b in coords], dtype=bool)


@dataclass
class Field:
    """One process at one timestamp: standardized residuals + coordinates.

    ``coords``/``values`` live on the full (possibly augmented) grid,
    ``coords_main``/``values_main`` on the base grid used for covariance
    assembly (src/fields.py:74-95). Coordinates are [lat, lon] rows for
    geodesic fields, [x, y] otherwise. Fields built from frames carry their
    ``trend`` statistics and the fitted OLS surface at both grids.
    """

    name: str
    timestamp: Optional[str]
    coords: torch.Tensor  # (n, 2)
    values: torch.Tensor  # (n,)
    coords_main: torch.Tensor  # (m, 2)
    values_main: torch.Tensor  # (m,)
    measurement_var: Optional[torch.Tensor] = None
    trend: Optional[TrendStats] = None
    geodesic: bool = True
    spatial_trend: Optional[np.ndarray] = None  # fitted OLS surface at coords
    spatial_trend_main: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    @classmethod
    def from_dataframe(cls, df, data_name: str, covariate_names: Sequence[str],
                       timestamp: str, main_coords: Optional[np.ndarray] = None) -> "Field":
        """Build a real-data Field from a long-format frame.

        Expects columns [time, lat, lon, <data_name>, <data_name>_var] plus
        covariates. ``main_coords`` is an (m, 2) [lat, lon] array of base
        grid centers (``data.grids.main_coords_array``); rows whose
        coordinates are in it become the ``_main`` subset (all rows when
        None). Raises ValueError when the timestamp has no data.
        """
        import pandas as pd

        var_name = f"{data_name}_var"
        df = df.copy()
        ts = pd.Timestamp(timestamp)

        # 1. temporal trend of the spatial mean series
        mean_series = df.groupby("time")[data_name].mean()
        tindex = np.arange(len(mean_series))
        trend_vals = fit_linear_trend(tindex, mean_series.values)
        trend_by_time = pd.Series(trend_vals, index=mean_series.index)
        df[data_name] = df[data_name] - df["time"].map(trend_by_time)
        if ts not in trend_by_time.index:
            raise ValueError(f"No data at timestamp {timestamp} for {data_name}.")
        temporal_trend = float(trend_by_time.loc[ts])

        # 2. select the timestamp, drop missing data rows
        sel = df[df["time"] == ts].dropna(subset=[data_name]).reset_index(drop=True)
        if len(sel) == 0:
            raise ValueError(f"No data at timestamp {timestamp} for {data_name}.")

        # 3. spatial trend by OLS on standardized covariates
        covs = sel[list(covariate_names)].values.astype(float)
        fitted, icpt, coefs, means, scales = fit_ols(sel[data_name].values.astype(float), covs)
        resid = sel[data_name].values - fitted

        # 4. standardize
        spatial_mean = float(np.nanmean(resid))
        scale_fact = float(np.nanstd(resid))
        standardized = (resid - spatial_mean) / scale_fact

        coords = sel[["lat", "lon"]].values.astype(float)
        mvar = sel[var_name].values.astype(float) if var_name in sel.columns else None
        if main_coords is not None:
            is_main = _coord_isin(coords, np.asarray(main_coords))
        else:
            is_main = np.ones(len(coords), dtype=bool)

        trend = TrendStats(
            temporal_trend=temporal_trend,
            spatial_mean=spatial_mean,
            scale_fact=scale_fact,
            ols_intercept=float(icpt),
            ols_coefs=np.asarray(coefs),
            covariate_means=np.asarray(means),
            covariate_scales=np.asarray(scales),
            covariate_names=tuple(covariate_names),
        )
        return cls(
            name=data_name,
            timestamp=str(ts.date()),
            coords=torch.as_tensor(coords),
            values=torch.as_tensor(standardized),
            coords_main=torch.as_tensor(coords[is_main]),
            values_main=torch.as_tensor(standardized[is_main]),
            measurement_var=None if mvar is None else torch.as_tensor(mvar),
            trend=trend,
            geodesic=True,
            spatial_trend=np.asarray(fitted),
            spatial_trend_main=np.asarray(fitted[is_main]),
        )

    @classmethod
    def from_arrays(cls, coords, values, name: str = "Z") -> "Field":
        """Simulated-field constructor (src/fields.py:90-94): raw values,
        Euclidean [x, y] coordinates, main == full. Float dtypes are kept."""
        c = np.asarray(coords)
        v = np.asarray(values)
        c = torch.as_tensor(c if c.dtype.kind == "f" else c.astype(float))
        v = torch.as_tensor(v if v.dtype.kind == "f" else v.astype(float))
        return cls(
            name=name,
            timestamp=None,
            coords=c,
            values=v,
            coords_main=c,
            values_main=v,
            geodesic=False,
        )

    def to_dataframe(self, main: bool = False):
        """The coordinates (lat/lon or x/y) and values as a pandas frame, on
        the full grid or (``main=True``) the main grid."""
        import pandas as pd

        coords = (self.coords_main if main else self.coords).cpu().numpy()
        values = (self.values_main if main else self.values).cpu().numpy()
        c1, c2 = ("lat", "lon") if self.geodesic else ("x", "y")
        return pd.DataFrame({c1: coords[:, 0], c2: coords[:, 1], self.name: values})

    def astype(self, dtype) -> "Field":
        """Cast the tensor members to ``dtype`` (the trend statistics and
        OLS surfaces stay float64)."""
        mv = self.measurement_var
        return replace(
            self,
            coords=self.coords.to(dtype),
            values=self.values.to(dtype),
            coords_main=self.coords_main.to(dtype),
            values_main=self.values_main.to(dtype),
            measurement_var=None if mv is None else mv.to(dtype),
        )


@dataclass
class MultiField:
    """p fields with per-process month offsets (src/fields.py:124-176)."""

    fields: List[Field]
    timestamp: Optional[str] = None
    timedeltas: Optional[List[int]] = None

    @classmethod
    def from_dataframes(cls, dfs, data_names: Sequence[str],
                        covariate_names: Sequence[Sequence[str]], timestamp: str,
                        timedeltas: Sequence[int],
                        main_coords: Optional[np.ndarray] = None) -> "MultiField":
        """One ``Field.from_dataframe`` per frame, process k at
        ``timestamp`` offset by ``timedeltas[k]`` months."""
        if not (len(dfs) == len(data_names) == len(covariate_names) == len(timedeltas)):
            raise ValueError("Not all input lists have the same length")
        fields = [
            Field.from_dataframe(df, name, covs, apply_timedelta(timestamp, delta),
                                 main_coords=main_coords)
            for df, name, covs, delta in zip(dfs, data_names, covariate_names, timedeltas)
        ]
        return cls(fields=fields, timestamp=timestamp, timedeltas=list(timedeltas))

    @property
    def n_procs(self) -> int:
        return len(self.fields)

    @property
    def n_data(self) -> int:
        return sum(f.size for f in self.fields)

    @property
    def geodesic(self) -> bool:
        return self.fields[0].geodesic

    def astype(self, dtype) -> "MultiField":
        return MultiField(
            fields=[f.astype(dtype) for f in self.fields],
            timestamp=self.timestamp,
            timedeltas=self.timedeltas,
        )


def apply_timedelta(timestamp: str, months: int) -> str:
    """Offset a timestamp by whole months (src/fields.py:173-176)."""
    import pandas as pd

    t = pd.Timestamp(timestamp) + pd.DateOffset(months=months)
    return str(t.date())
