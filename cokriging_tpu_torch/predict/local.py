"""Local-neighborhood cokriging, batched over prediction locations.

Counterpart of ``cokriging_tpu/predict/local.py``'s materialized-covariance
path (``LocalPredictor(materialize_cov=True)`` with the device neighborhood
search), after the reference point Predictor
(src/point_prediction.py:21-346):

1. the joint data covariance on the main grid is assembled once
   (``cov.matern.block_covariance``; on the card through the Matern kernel);
2. per location, the neighborhood is every datum within ``max_dist``,
   realized as a fixed-width index set: the K nearest candidates per
   process (K the largest neighborhood over all locations, bucketed), with
   lanes beyond the true neighborhood masked;
3. masked rows/columns become identity lanes, so one batched Cholesky solve
   serves every neighborhood size; a failed factorization gives NaN.

The host kd-tree path, the direct-assembly path and LOOCV come later.
"""

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import (
    block_covariance,
    covariance,
    cross_covariance,
)
from cokriging_tpu_torch.kernels.distance import distance_matrix
from cokriging_tpu_torch.kernels.linalg import spd_solve
from cokriging_tpu_torch.utils.config import resolve_device

# elements per (locations, K, K) buffer of one batch of local systems
_BATCH_ELEMS = 1 << 26
# elements per (locations, n_data) distance buffer of the width search
_WIDTH_ELEMS = 1 << 26


def _bucket_pow2(n, floor=8):
    """Round a width up to the next bucket in {2^k, 1.5 * 2^k} (>= floor):
    padded lanes cost at most a third more solve work, and months whose
    neighborhood sizes jitter share widths."""
    m = floor
    while m < n:
        if m + m // 2 >= n:
            return m + m // 2
        m *= 2
    return m


@dataclass
class LocalPrediction:
    """Predictions at ``coords`` ([lat, lon] or [x, y] rows): kriging mean,
    kriging standard error, and the neighborhood size of each location."""

    coords: np.ndarray
    pred: np.ndarray
    pred_err: np.ndarray
    n_neighbors: np.ndarray
    geodesic: bool = True

    def to_dataframe(self):
        """The reference's output frame: columns lat/lon (or x/y), pred,
        pred_err."""
        import pandas as pd

        c1, c2 = ("lat", "lon") if self.geodesic else ("x", "y")
        return pd.DataFrame(
            {
                c1: self.coords[:, 0],
                c2: self.coords[:, 1],
                "pred": self.pred,
                "pred_err": self.pred_err,
            }
        )


def _kmax(pcoords, coords, n_valid, max_dist, geodesic):
    """Largest neighborhood count per process over all locations, in
    location chunks that bound the distance buffer."""
    n_data = max(c.shape[0] for c in coords)
    chunk = max(1, _WIDTH_ELEMS // n_data)
    kmax = torch.zeros(len(coords), dtype=torch.int64, device=pcoords.device)
    for s in range(0, pcoords.shape[0], chunk):
        pc = pcoords[s : s + chunk]
        for j, cj in enumerate(coords):
            d = distance_matrix(pc, cj, geodesic)
            lane = torch.arange(d.shape[1], device=d.device)[None, :]
            within = (d <= max_dist) & (lane < n_valid[j])
            kmax[j] = torch.maximum(kmax[j], within.sum(dim=1).max())
    return kmax.cpu().tolist()


def _local_predict_batch(params, coords, values, joint_cov, pcoords, max_dist,
                         i, geodesic, k_each, n_valid):
    """Local prediction at every row of ``pcoords``: (pred, err, n_nb)."""
    p = len(coords)
    offsets = np.concatenate([[0], np.cumsum([c.shape[0] for c in coords])])[:-1]
    dev = pcoords.device
    c0 = covariance(params, i, torch.zeros(1, dtype=joint_cov.dtype, device=dev))[0]
    idx_local, dist_parts, mask_parts = [], [], []
    for j in range(p):
        d = distance_matrix(pcoords, coords[j], geodesic)
        lane = torch.arange(d.shape[1], device=dev)[None, :]
        within = (d <= max_dist) & (lane < n_valid[j])
        score = torch.where(within, d, torch.inf)
        # the K nearest candidates, ties in index order (as lax.top_k)
        dj, idx = torch.sort(score, dim=1, stable=True)
        dj, idx = dj[:, : k_each[j]], idx[:, : k_each[j]]
        mask = torch.isfinite(dj)
        idx_local.append(idx)
        dist_parts.append(torch.where(mask, dj, 0.0))
        mask_parts.append(mask)

    idx = torch.cat([idx_local[j] + int(offsets[j]) for j in range(p)], dim=1)
    mask = torch.cat(mask_parts, dim=1)
    m2 = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(idx.shape[1], dtype=joint_cov.dtype, device=dev)
    a = torch.where(m2, joint_cov[idx[:, :, None], idx[:, None, :]], eye)

    # prediction covariance vector (src/point_prediction.py:115-125)
    cvec = torch.cat(
        [
            covariance(params, i, dist_parts[j]) if j == i
            else cross_covariance(params, i, j, dist_parts[j])
            for j in range(p)
        ],
        dim=1,
    ) * mask
    z = torch.cat([values[j][idx_local[j]] for j in range(p)], dim=1) * mask

    w, solved = spd_solve(a, cvec)
    pred = torch.sum(w * z, dim=1)
    var = c0 - torch.sum(w * cvec, dim=1)
    err = torch.sqrt(torch.clamp_min(var, 0.0))
    n_nb = mask.sum(dim=1)
    ok = (n_nb > 0) & solved
    return (
        torch.where(ok, pred, torch.nan),
        torch.where(ok, err, torch.nan),
        n_nb,
    )


class LocalPredictor:
    """OO surface mirroring the reference point Predictor
    (src/point_prediction.py:21-346), on ``device`` (the card unless
    ``device="cpu"``)."""

    def __init__(self, mod, mf, device=None) -> None:
        if mod.n_procs != mf.n_procs:
            raise ValueError(
                "Number of theoretical processes different from empirical processes."
            )
        self.device = resolve_device(device)
        self.n_procs = mod.n_procs
        self.mod = mod
        self.mf = mf
        self.params = mod.params.to(device=self.device)
        # Pad each process's data to a bucketed length; padded lanes repeat
        # the first coordinate (finite covariances) and never enter a
        # neighborhood (the n_valid mask).
        coords, values, n_valid = [], [], []
        for f in mf.fields:
            c = np.asarray(f.coords_main)
            v = np.asarray(f.values_main)
            n = int(c.shape[0])
            m = _bucket_pow2(n, floor=64)
            if m > n:
                c = np.concatenate([c, np.repeat(c[:1], m - n, axis=0)])
                v = np.concatenate([v, np.zeros(m - n, v.dtype)])
            coords.append(torch.as_tensor(c, device=self.device))
            values.append(torch.as_tensor(v, device=self.device))
            n_valid.append(n)
        self._coords = tuple(coords)
        self._values = tuple(values)
        self._n_valid = tuple(n_valid)
        # joint covariance on the main grid, assembled once (reference
        # _cov_blocks, src/point_prediction.py:98-113)
        p = len(coords)
        dists = [
            [distance_matrix(coords[a], coords[b], mf.geodesic) if a <= b else None
             for b in range(p)]
            for a in range(p)
        ]
        with torch.no_grad():
            self.joint_cov = block_covariance(self.params, dists)

    def _neighborhood_widths(self, pcoords, max_dist):
        """Per-process K: the largest neighborhood over all locations,
        bucketed (masked lanes make any K >= the true width exact)."""
        kmax = _kmax(pcoords, self._coords, self._n_valid, max_dist, self.mf.geodesic)
        return tuple(
            min(_bucket_pow2(max(int(k), 1)), int(self._coords[j].shape[0]))
            for j, k in enumerate(kmax)
        )

    def __call__(self, i: int, pcoords, max_dist: float = 1e3,
                 postprocess: bool = False) -> LocalPrediction:
        """Cokrige process ``i`` at the (n_pred, 2) ``pcoords``."""
        if postprocess:
            raise NotImplementedError(
                "postprocessing to data scale needs fields built from data frames"
            )
        p_arr = np.atleast_2d(np.asarray(pcoords))
        pc = torch.as_tensor(p_arr, dtype=self.joint_cov.dtype, device=self.device)
        with torch.no_grad():
            k_each = self._neighborhood_widths(pc, max_dist)
            chunk = max(1, _BATCH_ELEMS // (sum(k_each) ** 2))
            parts = [
                _local_predict_batch(
                    self.params, self._coords, self._values, self.joint_cov,
                    pc[s : s + chunk], max_dist, i, self.mf.geodesic, k_each,
                    self._n_valid,
                )
                for s in range(0, pc.shape[0], chunk)
            ]
        pred, err, n_nb = (torch.cat([q[k] for q in parts]).cpu().numpy() for k in range(3))
        nan_mask = np.isnan(pred)
        if nan_mask.any():
            no_data = nan_mask & (n_nb == 0)
            singular = nan_mask & (n_nb > 0)
            if no_data.any():
                warnings.warn(
                    f"No data within maximum distance {max_dist} for"
                    f" {int(no_data.sum())} location(s); returning NaN."
                )
            if singular.any():
                warnings.warn(
                    f"Local covariance matrix is not positive definite for"
                    f" {int(singular.sum())} location(s) (invalid model"
                    f" parameters?); returning NaN."
                )
        return LocalPrediction(p_arr, pred, err, n_nb, self.mf.geodesic)
