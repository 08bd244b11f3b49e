"""Artifact checkpointing: fitted parameters and staged tables.

Counterpart of the parameter and table half of ``cokriging_tpu/utils/io.py``,
in the same file formats, so a file written by either package loads in the
other:

- ``save_params``/``load_params``: fitted MaternParams + spec + metadata as
  one .npz holding ``flat`` (the reference-ordered flat vector) and ``meta``
  (a JSON string: the spec's process count and bounds, and ``metadata``);
- ``save_table``/``load_table``: staged long-format frames as parquet when
  a parquet engine is available, else gzip-compressed pickle beside the path
  (``.pkl.gz``);
- ``save_dataset``/``load_dataset``: staged gridded frames as
  NetCDF4-compatible HDF5, the reference's interchange format.
"""

import json
from pathlib import Path

import numpy as np
import torch

from cokriging_tpu_torch.cov.params import MaternParams, ParamSpec


def save_params(path, params: MaternParams, metadata: dict = None) -> None:
    spec = params.spec
    meta = {
        "n_procs": spec.n_procs,
        "sigma_bounds": spec.sigma_bounds,
        "nu_bounds": spec.nu_bounds,
        "len_scale_bounds": spec.len_scale_bounds,
        "nugget_bounds": spec.nugget_bounds,
        "rho_bounds": spec.rho_bounds,
        "metadata": metadata or {},
    }
    np.savez(path, flat=params.to_flat().detach().cpu().numpy(), meta=json.dumps(meta))


def load_params(path) -> MaternParams:
    """The parameters of a ``save_params`` file, on the host in the flat
    vector's dtype."""
    with np.load(path, allow_pickle=False) as f:
        flat = f["flat"]
        meta = json.loads(str(f["meta"]))
    spec = ParamSpec(
        n_procs=int(meta["n_procs"]),
        sigma_bounds=tuple(meta["sigma_bounds"]),
        nu_bounds=tuple(meta["nu_bounds"]),
        len_scale_bounds=tuple(meta["len_scale_bounds"]),
        nugget_bounds=tuple(meta["nugget_bounds"]),
        rho_bounds=tuple(meta["rho_bounds"]),
    )
    return MaternParams.from_flat(torch.as_tensor(flat), spec=spec)


def save_table(path, df) -> None:
    """Stage a long-format frame to disk (parquet if available)."""
    path = Path(path)
    try:
        df.to_parquet(path)
    except Exception:
        df.to_pickle(path.with_suffix(".pkl.gz"), compression="gzip")


def load_table(path):
    """A frame staged by ``save_table``: the parquet file, else the gzip
    pickle beside it."""
    import pandas as pd

    path = Path(path)
    if path.exists():
        try:
            return pd.read_parquet(path)
        except Exception:
            pass
    alt = path.with_suffix(".pkl.gz")
    if alt.exists():
        return pd.read_pickle(alt, compression="gzip")
    return pd.read_parquet(path)


# ---------------------------------------------------------------------------
# NetCDF staged artifacts
# ---------------------------------------------------------------------------
#
# The reference checkpoints every ETL stage as NetCDF through xarray
# (src/data_utils.py:363-372 to_xarray; scripts/process_lite_files.ipynb
# cell 4), and downstream stages re-read those files. The file is written
# with h5py as NetCDF4-compatible HDF5, as the JAX package writes it:
# coordinate variables are HDF5 dimension scales attached to each data
# variable, the structure xarray's h5netcdf engine and the netCDF4 C library
# read. Time is encoded CF-style as "days since 1970-01-01".

_TIME_UNITS = "days since 1970-01-01"


def save_dataset(path, df, coords=("time", "lat", "lon"), data_vars=None) -> None:
    """Write a long-format frame as a gridded NetCDF artifact: pivoted onto
    the dense grid of the coordinates' sorted unique values (NaN holes for
    unobserved cells), one float64 (time, lat, lon)[...] variable per data
    column (all columns but the coordinates by default); the reference's
    ``set_index([...]).to_xarray().to_netcdf()`` stage."""
    import h5py
    import pandas as pd

    coords = tuple(coords)
    if data_vars is None:
        data_vars = [c for c in df.columns if c not in coords]
    axes = [np.sort(df[c].unique()) for c in coords]
    idx = tuple(df[c].map({v: k for k, v in enumerate(ax)}).values
                for c, ax in zip(coords, axes))
    shape = tuple(len(ax) for ax in axes)
    with h5py.File(path, "w") as f:
        for c, ax in zip(coords, axes):
            if c == "time":
                days = (pd.DatetimeIndex(ax) - pd.Timestamp("1970-01-01")) / pd.Timedelta(days=1)
                d = f.create_dataset(c, data=days.values.astype("f8"))
                d.attrs["units"] = _TIME_UNITS
                d.attrs["calendar"] = "proleptic_gregorian"
            else:
                d = f.create_dataset(c, data=np.asarray(ax, dtype="f8"))
            d.make_scale(c)
        for name in data_vars:
            cube = np.full(shape, np.nan, dtype="f8")
            cube[idx] = df[name].values.astype(float)
            d = f.create_dataset(name, data=cube, compression="gzip")
            d.attrs["_FillValue"] = np.nan
            for k, c in enumerate(coords):
                d.dims[k].attach_scale(f[c])


def load_dataset(path, as_frame=True):
    """Read a gridded NetCDF / HDF5 artifact (``save_dataset``'s, or any
    netCDF4 file whose variables carry dimension scales): a long-format
    frame of the coordinate columns and one column per variable, rows where
    every variable is NaN dropped (``as_frame=True``), or (cubes dict,
    coords dict). A coordinate whose units read "days since <epoch>"
    comes back as datetimes."""
    import h5py
    import pandas as pd

    with h5py.File(path, "r") as f:
        scales = {name for name in f if isinstance(f[name], h5py.Dataset) and f[name].is_scale}
        cubes, coords, dim_order = {}, {}, None
        for name in f:
            if name in scales or not isinstance(f[name], h5py.Dataset):
                continue
            d = f[name]
            dim_order = tuple(d.dims[k][0].name.lstrip("/") if len(d.dims[k]) else f"dim{k}"
                              for k in range(d.ndim))
            cubes[name] = d[()]
        for s in scales:
            vals = f[s][()]
            units = f[s].attrs.get("units", b"")
            units = units.decode() if isinstance(units, bytes) else str(units)
            if units.startswith("days since"):
                epoch = pd.Timestamp(units.split("since")[1].strip())
                vals = epoch + pd.to_timedelta(vals, unit="D")
            coords[s] = vals
    if not as_frame:
        return cubes, coords
    if dim_order is None:
        raise ValueError(f"No gridded variables found in {path}.")
    grid = np.meshgrid(*[np.asarray(coords[d]) for d in dim_order], indexing="ij")
    out = {d: g.ravel() for d, g in zip(dim_order, grid)}
    for name, cube in cubes.items():
        out[name] = cube.ravel()
    frame = pd.DataFrame(out)
    keep = ~frame[list(cubes)].isna().all(axis=1)
    return frame.loc[keep].reset_index(drop=True)
