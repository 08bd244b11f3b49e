"""Multivariate Matern parameter system.

Counterpart of ``cokriging_tpu/cov/params.py``: the same ``ParamSpec``
bounds and the same flat order (reference: src/model.py:145-152),

    p = 2: [sigma_11, sigma_22,
            nu_11, nu_12, nu_22,
            len_scale_11, len_scale_12, len_scale_22,
            nugget_11, nugget_22,
            rho_12]                      -> 11 free parameters

held as dense torch tensors. ``from_flat`` builds the matrices by indexing
the flat vector, so autograd carries gradients from any matrix entry back to
the flat parameter it came from.
"""

from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np
import torch


def _triu_pairs(p, k=0):
    return [(i, j) for i in range(p) for j in range(p) if i + k <= j]


@dataclass(frozen=True)
class ParamSpec:
    """Static metadata: names, bounds, and flat-vector slicing for p procs."""

    n_procs: int = 2
    sigma_bounds: Tuple[float, float] = (0.4, 3.5)
    nu_bounds: Tuple[float, float] = (0.2, 3.5)
    len_scale_bounds: Tuple[float, float] = (1e2, 2e3)
    nugget_bounds: Tuple[float, float] = (0.0, 0.2)
    rho_bounds: Tuple[float, float] = (-1.0, 1.0)

    @property
    def n_params(self):
        p = self.n_procs
        t = p * (p + 1) // 2
        s = p * (p - 1) // 2
        return p + t + t + p + s

    def names(self):
        p = self.n_procs
        out = [f"sigma_{i+1}{i+1}" for i in range(p)]
        out += [f"nu_{i+1}{j+1}" for i, j in _triu_pairs(p)]
        out += [f"len_scale_{i+1}{j+1}" for i, j in _triu_pairs(p)]
        out += [f"nugget_{i+1}{i+1}" for i in range(p)]
        out += [f"rho_{i+1}{j+1}" for i, j in _triu_pairs(p, k=1)]
        return out

    def bounds(self):
        """(lower, upper) arrays in flat order."""
        p = self.n_procs
        t = p * (p + 1) // 2
        s = p * (p - 1) // 2
        lo, hi = [], []
        for bnds, count in [
            (self.sigma_bounds, p),
            (self.nu_bounds, t),
            (self.len_scale_bounds, t),
            (self.nugget_bounds, p),
            (self.rho_bounds, s),
        ]:
            lo += [bnds[0]] * count
            hi += [bnds[1]] * count
        return np.array(lo), np.array(hi)


@dataclass(frozen=True)
class MaternParams:
    """Dense tensors of multivariate Matern parameters.

    ``nu``, ``len_scale``, ``rho`` are full symmetric (p, p) matrices;
    ``sigma`` and ``nugget`` are (p,) marginals. ``rho``'s diagonal is 1.
    """

    sigma: torch.Tensor
    nu: torch.Tensor
    len_scale: torch.Tensor
    nugget: torch.Tensor
    rho: torch.Tensor
    spec: ParamSpec = field(default=ParamSpec())

    @property
    def n_procs(self):
        return self.spec.n_procs

    @staticmethod
    def default(
        n_procs: int = 2, spec: ParamSpec = None, dtype=torch.float64,
        device="cpu",
    ) -> "MaternParams":
        spec = spec or ParamSpec(n_procs=n_procs)
        p = spec.n_procs
        kw = dict(dtype=dtype, device=device)
        return MaternParams(
            sigma=torch.ones(p, **kw),
            nu=torch.full((p, p), 1.5, **kw),
            len_scale=torch.full((p, p), 5e2, **kw),
            nugget=torch.zeros(p, **kw),
            rho=torch.eye(p, **kw),
            spec=spec,
        )

    @staticmethod
    def from_flat(x, spec: ParamSpec = None, n_procs: int = 2) -> "MaternParams":
        """Build from the reference-ordered flat vector (src/model.py:145).
        Keeps the caller's float dtype and device; differentiable in x. A
        leading batch shape of x (the batched WLS fits) is kept on every
        member: sigma (..., p), nu (..., p, p) and so on."""
        spec = spec or ParamSpec(n_procs=n_procs)
        p = spec.n_procs
        x = torch.as_tensor(x)
        if not x.is_floating_point():
            x = x.to(torch.get_default_dtype())
        if x.ndim == 0 or x.shape[-1] != spec.n_params:
            raise ValueError(
                f"flat vector has {x.shape[-1] if x.ndim else 1} entries, spec needs "
                f"{spec.n_params}"
            )
        t = p * (p + 1) // 2
        s = p * (p - 1) // 2
        sigma = x[..., :p]
        nu = _sym_from_triu(x[..., p : p + t], p, k_diag=0)
        len_scale = _sym_from_triu(x[..., p + t : p + 2 * t], p, k_diag=0)
        nugget = x[..., p + 2 * t : 2 * p + 2 * t]
        rho = _sym_from_triu(x[..., 2 * p + 2 * t : 2 * p + 2 * t + s], p, k_diag=1)
        rho = rho + torch.eye(p, dtype=x.dtype, device=x.device)
        return MaternParams(sigma, nu, len_scale, nugget, rho, spec)

    def to_flat(self) -> torch.Tensor:
        p = self.n_procs
        iu = torch.triu_indices(p, p, device=self.nu.device)
        iu1 = torch.triu_indices(p, p, offset=1, device=self.rho.device)
        return torch.cat(
            [
                self.sigma,
                self.nu[iu[0], iu[1]],
                self.len_scale[iu[0], iu[1]],
                self.nugget,
                self.rho[iu1[0], iu1[1]],
            ]
        )

    def with_flat(self, x) -> "MaternParams":
        return MaternParams.from_flat(x, spec=self.spec)

    def replace(self, **kw) -> "MaternParams":
        return replace(self, **kw)

    def astype(self, dtype) -> "MaternParams":
        """Cast all parameter tensors (e.g. f32 for the card's fast path)."""
        return self.to(dtype=dtype)

    def to(self, device=None, dtype=None) -> "MaternParams":
        """Move and/or cast all parameter tensors."""
        return MaternParams(
            *(
                t.to(device=device, dtype=dtype)
                for t in (self.sigma, self.nu, self.len_scale, self.nugget, self.rho)
            ),
            spec=self.spec,
        )

    # ---- host-side reporting -------------------------------------------

    def to_dataframe(self):
        """Names, values and (lower, upper) bounds in flat order, as a
        pandas frame."""
        import pandas as pd

        lo, hi = self.spec.bounds()
        return pd.DataFrame(
            {
                "name": self.spec.names(),
                "value": self.to_flat().detach().cpu().numpy(),
                "bounds": list(zip(lo, hi)),
            }
        )


def _sym_from_triu(vals, p, k_diag=0):
    """Scatter upper-triangle values (row-major) into a symmetric matrix;
    entries below the k_diag-th diagonal band that have no value are 0."""
    iu = np.triu_indices(p, k=k_diag)
    idx = np.full((p, p), len(iu[0]))  # points at the appended zero
    idx[iu] = np.arange(len(iu[0]))
    idx[(iu[1], iu[0])] = np.arange(len(iu[0]))
    padded = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], dim=-1)
    return padded[..., torch.as_tensor(idx, device=vals.device)]
