"""Exact cofield simulation by multivariate circulant embedding (FFT).

Counterpart of ``cokriging_tpu/sim/spectral.py``. The dense simulator
(``sim.cofield.MultivariateRandomField``) factorizes the joint pn x pn
covariance with one Cholesky: O(p^3 n^3) flops and O(p^2 n^2) memory, which
caps grids at a few thousand cells. On a regular Cartesian grid the
stationary (cross-)covariance is block circulant once the grid is embedded
in a torus, so the joint factorization diagonalizes under the 2-D DFT: per
frequency only a p x p PSD square root remains (Chan & Wood 1999,
"Simulation of stationary Gaussian vector fields"). Draws are exact
whenever the embedding is PSD, which the constructor verifies and repairs by
doubling the torus.

The spectrum is built once: the covariance blocks on the torus lag grid go
through ``matern_correlation_block`` (on the card the Matern kernel, one
full 2-D block of lags per pair), and the DFT, the PSD verdict and the
per-frequency square root B run on the host in float64 numpy. The draws run
on the field's device in float64 / complex128: B times complex normals, one
``torch.fft.fft2``, Re and Im as two independent draws.

Sampling semantics (``sample``, ``to_fields``, ``truth_at``) are inherited
from the dense simulator, so the validation harness (semi-colocated sampling
and measurement error, src/sim.py:67-117) is shared.
"""

import math
import warnings

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import covariance_block
from cokriging_tpu_torch.sim.cofield import CartesianGrid, MultivariateRandomField, _standard_normal
from cokriging_tpu_torch.utils.config import resolve_device


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _axis_spec(values: np.ndarray):
    """(points, count, spacing) of one regular grid axis."""
    pts = np.unique(values)
    if len(pts) > 1:
        d = np.diff(pts)
        if not np.allclose(d, d[0], rtol=1e-8):
            raise ValueError("circulant embedding requires a regular grid axis")
        dx = float(d[0])
    else:
        dx = 1.0
    return pts, len(pts), dx


def _minimal_image_lags(m: int, dx: float) -> np.ndarray:
    """Signed torus lags k*dx with k wrapped to (-m/2, m/2]."""
    k = np.arange(m)
    k = np.where(k <= m // 2, k, k - m)
    return k * dx


class SpectralRandomField(MultivariateRandomField):
    """p-process Gaussian cofield simulator, exact via circulant embedding,
    on ``device`` (the card unless ``device="cpu"``).

    Drop-in alternative to ``MultivariateRandomField`` on a
    ``CartesianGrid``: the same ``.fields`` / ``.sample`` / ``.to_fields`` /
    ``.truth_at`` surface, plus ``sample_ensemble`` for many full-grid
    realizations at once. The grid must be regular (a CartesianGrid always
    is); distances are Euclidean, as on the reference's simulation path
    (src/sim.py:24-27).

    Args:
        model: ``MultivariateMatern`` (any p).
        grid: ``CartesianGrid``.
        seed: generator seed of the resident ``.fields`` realization.
        pad_factor: initial torus size per axis as a multiple of the grid
            size (>= 2 keeps all grid lags inside the minimal image).
        max_doublings: embedding-repair attempts; each retry doubles the
            torus, which shrinks (often removes) negative spectral mass.
        clip_tol: relative negative-eigenvalue mass allowed to be clipped
            to zero after the final doubling before erroring.
    """

    def __init__(
        self,
        model,
        grid: CartesianGrid,
        seed: int = 0,
        pad_factor: float = 2.0,
        max_doublings: int = 3,
        clip_tol: float = 1e-6,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.seed = seed
        self.mod = model
        self.n_procs = model.n_procs
        self.grid = grid
        self.coords = grid.coords

        _, nx, dx = _axis_spec(grid.coords["x"].values)
        _, ny, dy = _axis_spec(grid.coords["y"].values)
        if nx * ny != grid.count:
            raise ValueError("grid is not a full regular lattice")
        self._nx, self._ny = nx, ny

        mx = _next_pow2(max(2 * nx, int(np.ceil(pad_factor * nx))))
        my = _next_pow2(max(2 * ny, int(np.ceil(pad_factor * ny))))
        for attempt in range(max_doublings + 1):
            spec, min_rel = self._build_spectrum(mx, my, dx, dy)
            if min_rel >= -clip_tol:
                break
            if attempt < max_doublings:
                mx, my = 2 * mx, 2 * my
        else:
            raise np.linalg.LinAlgError(
                "circulant embedding is not PSD after "
                f"{max_doublings} doublings (min relative eigenvalue "
                f"{min_rel:.3e}). A deficit that does not shrink with "
                "embedding size means the model itself is invalid (the "
                "continuous spectral matrices have negative determinant "
                "somewhere): check cov.spectral.rho_max / repair with "
                "cov.spectral.project_to_valid."
            )
        # eigvalsh rounding noise sits at the ~1e-15 level even for models
        # that are PSD in exact arithmetic; only warn on meaningful mass
        if min_rel < -1e-12:
            warnings.warn(f"clipped {-min_rel:.2e} relative negative spectral mass")
        self._mx, self._my = mx, my
        self.min_rel_eig = float(min_rel)
        # per-frequency PSD square root B(k) = V sqrt(max(w, 0)) V^T, built
        # on the host in float64
        w, v = np.linalg.eigh(spec)
        w = np.maximum(w, 0.0)
        B = np.einsum("xyik,xyk,xyjk->xyij", v, np.sqrt(w), v)
        self._B = torch.as_tensor(B, device=self.device)
        self.fields = self._simulate()

    def _build_spectrum(self, mx, my, dx, dy):
        """(mx, my, p, p) real spectral matrices, the 2-D DFT of every
        (cross-)covariance block on the torus lag grid, and the most
        negative eigenvalue relative to the largest. The blocks are
        evaluated on the field's device; the DFT and the eigenvalues on the
        host in float64."""
        p = self.n_procs
        lx = torch.as_tensor(_minimal_image_lags(mx, dx), device=self.device)
        ly = torch.as_tensor(_minimal_image_lags(my, dy), device=self.device)
        h = torch.sqrt(lx[:, None] ** 2 + ly[None, :] ** 2)
        params = self.mod.params.to(device=self.device, dtype=torch.float64)
        blocks = [[None] * p for _ in range(p)]
        with torch.no_grad():
            for i in range(p):
                for j in range(i, p):
                    c = covariance_block(params, i, j, h).cpu().numpy()
                    blocks[i][j] = blocks[j][i] = np.real(np.fft.fft2(c))
        spec = np.stack([np.stack(row, axis=-1) for row in blocks], axis=-1)  # (mx, my, p, p)
        w = np.linalg.eigvalsh(spec)
        return spec, float(w.min() / np.abs(w).max())

    def _eps(self, seed: int, n_draw: int) -> torch.Tensor:
        """(n_draw, mx, my, p) complex standard normals (real and imaginary
        parts independent N(0, 1))."""
        re, im = _standard_normal(seed, (2, n_draw, self._mx, self._my, self.n_procs),
                                  self.device)
        return torch.complex(re, im)

    def _draw(self, seed: int, n_samples: int) -> torch.Tensor:
        """(n_samples, p, nx, ny) exact realizations.

        y(k) = B(k) eps(k) with eps complex standard normal
        (E[eps eps^H] = 2 I); Re and Im of FFT(y)/sqrt(M) are two
        independent N(0, C) draws (Dietrich & Newsam 1997 eq. 3.4), so one
        complex pass yields two samples.
        """
        n_draw = (n_samples + 1) // 2
        eps = self._eps(seed, n_draw)
        B = self._B.to(eps.dtype)
        with torch.no_grad():
            y = torch.einsum("xyij,sxyj->sxyi", B, eps)
            y = torch.fft.fft2(y, dim=(1, 2)) / math.sqrt(self._mx * self._my)
            out = torch.cat([y.real, y.imag], dim=0)
        out = out[:n_samples, : self._nx, : self._ny, :]
        return torch.movedim(out, -1, 1)

    def _simulate(self) -> list:
        vals = self._draw(self.seed, 1)[0].cpu().numpy()  # (p, nx, ny)
        # (nx, ny) C-order == grid ordering (x outer, y inner)
        return self._frames(vals.reshape(self.n_procs, -1))

    def sample_ensemble(self, n_samples: int, seed=None) -> torch.Tensor:
        """(n_samples, p, nx, ny) independent full-grid realizations on the
        field's device: the ensemble studies the dense simulator cannot
        reach (its per-realization cost is an O(p^3 n^3) factorization)."""
        return self._draw(self.seed if seed is None else seed, n_samples)

    def embedded_covariance(self, i: int, j: int) -> torch.Tensor:
        """(mx, my) torus covariance the sampler realizes for the (i, j)
        pair: equal to the model block exactly when nothing was clipped."""
        s = torch.einsum("xyik,xyjk->xyij", self._B, self._B)[..., i, j]
        return torch.fft.ifft2(s).real
