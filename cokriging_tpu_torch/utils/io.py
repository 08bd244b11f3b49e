"""Artifact checkpointing: fitted parameters and staged tables.

Counterpart of the parameter and table half of ``cokriging_tpu/utils/io.py``,
in the same file formats, so a file written by either package loads in the
other:

- ``save_params``/``load_params``: fitted MaternParams + spec + metadata as
  one .npz holding ``flat`` (the reference-ordered flat vector) and ``meta``
  (a JSON string: the spec's process count and bounds, and ``metadata``);
- ``save_table``/``load_table``: staged long-format frames as parquet when
  a parquet engine is available, else gzip-compressed pickle beside the path
  (``.pkl.gz``).
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
