"""Multivariate Gaussian cofield simulation.

Counterpart of ``cokriging_tpu/sim/cofield.py`` (the reference simulator,
src/sim.py:11-137): a joint pn x pn Matern block covariance over a
Cartesian grid, one lower Cholesky factor, cofields = L @ N(0, 1). The
semi-colocated sampling scheme (half the sample locations shared between all
processes, half disjoint per process, src/sim.py:67-82) and per-process
additive measurement error (src/sim.py:84-117) are preserved: this is the
framework's end-to-end validation harness (parameter recovery and
prediction-interval coverage).

The joint covariance is ``cov.matern.block_covariance`` over the grid's
distances, so on the card the marginal blocks go through the symmetric
launch of the Matern kernel and the cross blocks through the full one. The
simulator runs in float64: the zero-nugget systems need the conditioning.
Its normals come from a ``torch.Generator`` on the field's device seeded
from ``seed`` (the draws cannot be the JAX package's, whose PRNG is JAX's
own); the sample locations come from numpy's ``default_rng`` in both
packages, index for index. The fields and samples are pandas frames, so
pandas is imported where they are made.

The reference is bivariate-only; here p = model.n_procs, with exactly the
reference's sampling sequence at p = 2 (``BivariateRandomField`` is the
parity alias).
"""

from typing import List, Optional

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import block_covariance
from cokriging_tpu_torch.fields.field import Field, MultiField
from cokriging_tpu_torch.kernels.distance import euclidean_matrix
from cokriging_tpu_torch.utils.config import resolve_device


def _standard_normal(seed: int, shape, device) -> torch.Tensor:
    """float64 N(0, 1) draws of ``shape`` on ``device`` from a generator
    seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=torch.float64, device=device)


def _joint_cov_chol(params, dist, p):
    """Joint pn x pn block covariance over the one (n, n) distance matrix
    ``dist`` (every pair of processes shares the grid) and its lower
    Cholesky factor; the factor is None when the covariance is not
    positive definite."""
    cmat = block_covariance(params, [[dist] * p for _ in range(p)])
    chol, info = torch.linalg.cholesky_ex(cmat)
    if bool(info != 0) or not bool(torch.isfinite(chol.diagonal()).all()):
        return cmat, None
    return cmat, chol


class CartesianGrid:
    """Regular Cartesian grid on the unit square (src/sim.py:11-27), in
    expand-grid order (x outer, y inner). ``device`` is where ``dist`` is
    made (the card unless ``device="cpu"``)."""

    def __init__(self, xbounds=(0, 1), ybounds=(0, 1), xcount=51, ycount=51, device=None):
        import pandas as pd

        x = np.linspace(*xbounds, num=xcount)
        y = np.linspace(*ybounds, num=ycount)
        xx, yy = np.meshgrid(x, y)
        pts = np.array([xx, yy]).T.reshape(-1, 2)
        self.coords = pd.DataFrame(pts, columns=["x", "y"])
        self.count = len(self.coords)
        self.device = device
        self._dist = None

    @property
    def dist(self) -> torch.Tensor:
        """Full n x n Euclidean distance matrix (float64), made on first use
        so that the spectral simulator, which never reads it, can use grids
        whose dense matrix would not fit."""
        if self._dist is None:
            pts = torch.as_tensor(self.coords.to_numpy(copy=True), device=resolve_device(self.device))
            self._dist = euclidean_matrix(pts, pts)
        return self._dist


class MultivariateRandomField:
    """Simulate and sample a p-process Gaussian cofield (src/sim.py:30-137,
    generalized from the reference's bivariate-only class), on ``device``
    (the card unless ``device="cpu"``) in float64."""

    def __init__(self, model, grid: CartesianGrid, seed: int = 0, device=None) -> None:
        self.device = resolve_device(device)
        self.seed = seed
        self.mod = model
        self.n_procs = model.n_procs
        self.grid = grid
        self.coords = grid.coords
        params = model.params.to(device=self.device, dtype=torch.float64)
        dist = grid.dist.to(self.device)
        with torch.no_grad():
            self.cmat, self.chol_lower = _joint_cov_chol(params, dist, self.n_procs)
        if self.chol_lower is None:
            raise np.linalg.LinAlgError(
                "Joint simulation covariance is not positive definite."
            )
        self.fields = self._simulate()

    def _field_noise(self) -> torch.Tensor:
        """The (p n,) standard normals of the resident realization."""
        return _standard_normal(self.seed, (self.n_procs * self.grid.count,), self.device)

    def _frames(self, values) -> list:
        """One frame [x, y, value] per process from (p, n) host values."""
        import pandas as pd

        return [
            pd.DataFrame({"x": self.coords["x"].values, "y": self.coords["y"].values,
                          "value": values[i]})
            for i in range(self.n_procs)
        ]

    def _simulate(self) -> list:
        with torch.no_grad():
            sim = (self.chol_lower @ self._field_noise()).cpu().numpy()
        return self._frames(sim.reshape(self.n_procs, self.grid.count))

    def _split_samp_coords(self, size: int, seed: int) -> List[np.ndarray]:
        """Half-colocated / half-disjoint sample locations (src/sim.py:67-82).

        n_co locations are shared by all p processes; each process gets its
        own n_mis disjoint extras. At p = 2, n_ext == floor(1.5 size): the
        reference's draw, index for index."""
        p = self.n_procs
        n_co = int(np.ceil(size / 2))
        n_mis = size - n_co
        n_ext = n_co + p * n_mis
        rng = np.random.default_rng(seed)
        rows = rng.choice(self.grid.count, size=n_ext, replace=False)
        co = rows[:n_co]
        mis = [rows[n_co + k * n_mis: n_co + (k + 1) * n_mis] for k in range(p)]
        return [np.concatenate([co, mis[i]]) for i in range(p)]

    def _sample_noise(self, seed: int, size: int) -> np.ndarray:
        """(p, size) standard normals of the measurement errors."""
        return _standard_normal(seed, (self.n_procs, size), self.device).cpu().numpy()

    def sample(
        self,
        size: Optional[int] = None,
        frac: Optional[float] = None,
        epsilon=(0.0,),
        seed: Optional[int] = None,
    ) -> list:
        """Sample the cofields with additive N(0, eps_i^2) measurement error
        (src/sim.py:84-117): one frame [x, y, Z<i>] per process."""
        p = self.n_procs
        if frac is not None:
            size = int(np.ceil(frac * self.grid.count))
        n_need = int(np.ceil(size / 2)) + p * (size - int(np.ceil(size / 2)))
        assert n_need <= self.grid.count, (
            "Sample size is too large for semi-colocated sampling scheme."
        )
        eps = np.asarray(epsilon, dtype=float)
        if eps.size == 1:
            eps = np.repeat(eps, p)
        seed = self.seed if seed is None else seed

        idx = self._split_samp_coords(size, seed)
        noise = self._sample_noise(seed + 1, size)
        samples = []
        for i in range(p):
            df = self.fields[i].iloc[idx[i]].reset_index(drop=True).copy()
            df["value"] = df["value"] + noise[i] * eps[i]
            samples.append(df.rename(columns={"value": f"Z{i}"}))
        return samples

    def to_fields(self, samples: list, i: Optional[int] = None) -> MultiField:
        """Format samples as a (Multi)Field on Euclidean coordinates
        (src/sim.py:127-137)."""
        fields = [
            Field.from_arrays(s[["x", "y"]].values, s[f"Z{k}"].values, name=f"Z{k}")
            for k, s in enumerate(samples)
        ]
        if i is not None:
            return MultiField(fields=[fields[i]])
        return MultiField(fields=fields)

    def truth_at(self, i: int, coords: np.ndarray) -> np.ndarray:
        """Noise-free simulated values of process i at exact grid coords."""
        df = self.fields[i]
        key = {(round(a, 12), round(b, 12)): v for a, b, v in df.values}
        return np.array([key[(round(a, 12), round(b, 12))] for a, b in coords])


#: Reference-parity name (src/sim.py:30); the same sampling at p = 2.
BivariateRandomField = MultivariateRandomField
