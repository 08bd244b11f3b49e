"""Satellite granule readers (OCO-2 SIF/XCO2 Lite, MODIS EVI, TransCom).

Counterpart of ``cokriging_tpu/data/readers.py``, the long-format pandas
re-design of the reference's xarray readers (src/data_utils.py:21-118).
Each reader returns a DataFrame with columns [time, lat, lon, <name>,
<name>_var] after the reference's quality filters:

- SIF: drop Quality_Flag == 2 and SIF + 3 sigma <= 0; measurement-error
  variance = uncertainty^2 (src/data_utils.py:21-58);
- XCO2: keep xco2_quality_flag == 0; conservative error variance =
  2 x posterior uncertainty (src/data_utils.py:61-93).

Inputs are h5py files (NetCDF4 granules open as HDF5) or plain
dict-of-arrays: anything indexable by variable name. Host code only; pandas
and h5py are imported inside the functions, so the array path never loads
them.
"""

from typing import Sequence

import numpy as np


def _get(ds, name):
    """A variable of a dict / h5py input as a numpy array."""
    return np.asarray(ds[name])


def _parse_time(t, epoch: str):
    """Granule timestamps -> datetime64 values.

    Real OCO-2 Lite files store numeric seconds since an instrument epoch
    (SIF Lite ``Delta_Time``: seconds since 1993-01-01; FP Lite ``time``:
    seconds since 1970-01-01); numeric input is converted from the named
    epoch, datetime64 or string input passes through. Returned as positional
    values, since the caller assigns into a quality-filtered frame whose
    index has gaps.
    """
    import pandas as pd

    t = pd.Series(np.asarray(t).ravel())
    if np.issubdtype(t.dtype, np.number):
        out = pd.Timestamp(epoch) + pd.to_timedelta(t, unit="s")
    else:
        out = pd.to_datetime(t)
    return out.to_numpy()


def prep_sif(ds):
    """Clean an OCO-2 SIF Lite granule (src/data_utils.py:21-58)."""
    import pandas as pd

    df = pd.DataFrame({
        "sif": _get(ds, "Daily_SIF_740nm"),
        "sif_sigma": _get(ds, "SIF_Uncertainty_740nm"),
        "flag": _get(ds, "Quality_Flag"),
        "lon": _get(ds, "Longitude"),
        "lat": _get(ds, "Latitude"),
        "time": _get(ds, "Delta_Time"),
    })
    df = df[df["flag"] != 2]
    df = df[df["sif"] + 3.0 * df["sif_sigma"] > 0]
    df["sif_var"] = df["sif_sigma"] ** 2
    df["time"] = _parse_time(df["time"], "1993-01-01")
    return df[["time", "lat", "lon", "sif", "sif_var"]].reset_index(drop=True)


def prep_xco2(ds):
    """Clean an OCO-2 FP Lite granule (src/data_utils.py:61-93)."""
    import pandas as pd

    df = pd.DataFrame({
        "xco2": _get(ds, "xco2"),
        "xco2_uncert": _get(ds, "xco2_uncertainty"),
        "flag": _get(ds, "xco2_quality_flag"),
        "lon": _get(ds, "longitude"),
        "lat": _get(ds, "latitude"),
        "time": _get(ds, "time"),
    })
    df = df[df["flag"] == 0]
    df["xco2_var"] = df["xco2_uncert"] * 2.0
    df["time"] = _parse_time(df["time"], "1970-01-01")
    return df[["time", "lat", "lon", "xco2", "xco2_var"]].reset_index(drop=True)


def prep_evi(ds, extents=(-130, 18, -60, 62), date: str = None):
    """Clip a MODIS monthly EVI grid to the study box
    (src/data_utils.py:96-108). Expects 'evi' plus 1-d 'lon'/'lat' axes."""
    import pandas as pd

    evi = _get(ds, "evi")
    lon_g, lat_g = np.meshgrid(_get(ds, "lon"), _get(ds, "lat"), indexing="ij")
    df = pd.DataFrame({"lon": lon_g.ravel(), "lat": lat_g.ravel(), "evi": evi.ravel()})
    minx, miny, maxx, maxy = extents
    df = df[(df.lon >= minx) & (df.lon <= maxx) & (df.lat >= miny) & (df.lat <= maxy)]
    if date is not None:
        df["time"] = pd.Timestamp(date)
    return df.reset_index(drop=True)


def read_transcom(ds_or_df):
    """TransCom-3 region map filtered to land regions 1..11
    (src/data_utils.py:111-118)."""
    import pandas as pd

    if isinstance(ds_or_df, pd.DataFrame):
        df = ds_or_df.copy()
    else:
        df = pd.DataFrame({
            "lon": _get(ds_or_df, "lon"),
            "lat": _get(ds_or_df, "lat"),
            "region": _get(ds_or_df, "region"),
        })
    df = df[(df.region < 12) & (df.region != 0)]
    return df.reset_index(drop=True)


def read_transcom_binary(path: str):
    """The land-region frame of the raw TransCom-3 region map, a big-endian
    IDL binary (360 x 180 int32 grid, optionally wrapped in 4-byte record
    markers; the reference converts it with an R script,
    scripts/convert_bin_file.R:20-90)."""
    import pandas as pd

    raw = np.fromfile(path, dtype=">i4")
    if raw.size == 360 * 180 + 2:
        raw = raw[1:-1]
    if raw.size != 360 * 180:
        raise ValueError(f"Unexpected TransCom binary size: {raw.size}")
    region = raw.reshape(180, 360).astype(np.int32)
    lon_g, lat_g = np.meshgrid(np.arange(-179.5, 180.0, 1.0), np.arange(-89.5, 90.0, 1.0))
    return read_transcom(pd.DataFrame({
        "lon": lon_g.ravel(), "lat": lat_g.ravel(), "region": region.ravel().astype(float),
    }))


def open_mf(paths: Sequence[str], prep_fn, workers: int = 8):
    """Apply a reader across granule files (.nc / .nc4 / .h5, through h5py)
    and concatenate the frames in path order: the reference's
    ``open_mfdataset(parallel=True)`` + preprocess pattern
    (scripts/process_lite_files.ipynb cell 2). The granules load on a
    thread pool of ``workers`` (h5py releases the GIL during I/O and
    decompression); ``workers=1`` reads them in turn."""
    from concurrent.futures import ThreadPoolExecutor

    import h5py
    import pandas as pd

    def load(p):
        with h5py.File(p, "r") as f:
            return prep_fn(f)

    paths = list(paths)
    if workers <= 1 or len(paths) <= 1:
        frames = [load(p) for p in paths]
    else:
        with ThreadPoolExecutor(max_workers=min(workers, len(paths))) as ex:
            frames = list(ex.map(load, paths))
    return pd.concat(frames, ignore_index=True)
