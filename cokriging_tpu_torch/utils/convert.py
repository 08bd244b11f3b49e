"""Carrying parameters across from the JAX package.

The two packages share no code, so a model fitted by ``cokriging_tpu`` comes
across as numpy data: its flat vector (``np.asarray(params.to_flat())``) in
the reference order that both packages use.
"""

import numpy as np
import torch

from cokriging_tpu_torch.cov.params import MaternParams


def params_from_numpy(flat, n_procs: int = 2, device="cpu") -> MaternParams:
    """``MaternParams`` from a flat numpy vector in the reference order,
    keeping its float dtype."""
    x = np.asarray(flat)
    if x.dtype.kind != "f":
        x = x.astype(np.float64)
    return MaternParams.from_flat(
        torch.as_tensor(x, device=device), n_procs=n_procs
    )
