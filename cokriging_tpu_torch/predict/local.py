"""Local-neighborhood cokriging, batched over prediction locations.

Counterpart of ``cokriging_tpu/predict/local.py``, after the reference
point Predictor (src/point_prediction.py:21-346):

1. the joint data covariance on the main grid is assembled once
   (``cov.matern.block_covariance``; on the card through the Matern kernel),
   or, with ``materialize_cov=False``, never: each local system is then
   assembled from its gathered neighborhood coordinates
   (``cov.matern.gathered_covariance``; on the card through the
   gathered-pairs kernel), O(n) memory in all;
2. per location, the neighborhood is every datum within ``max_dist``,
   realized as a fixed-width index set: the K nearest candidates per
   process (K the largest neighborhood over all locations, bucketed), with
   lanes beyond the true neighborhood masked. The candidates come from a
   masked sort over each location's distance row on the device or, on the
   direct path past ``KD_AUTO_THRESHOLD`` points (or with
   ``neighbor_method="kd"``), from host kd-trees;
3. masked rows/columns become identity lanes, so one batched Cholesky solve
   serves every neighborhood size; a failed factorization gives NaN.

LOOCV (``cross_validation``) comes later.
"""

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from cokriging_tpu_torch.cov.matern import (
    block_covariance,
    covariance,
    cross_covariance,
    gathered_covariance,
    pair_table,
)
from cokriging_tpu_torch.kernels.distance import distance_matrix
from cokriging_tpu_torch.kernels.linalg import spd_solve
from cokriging_tpu_torch.utils.config import EARTH_RADIUS_KM, resolve_device

# elements per (locations, K, K) buffer of one batch of local systems
_BATCH_ELEMS = 1 << 26
# elements per (locations, n_data) distance buffer of the width search
_WIDTH_ELEMS = 1 << 26
# the direct path's two ceilings on locations per batch: K^2 entries of the
# gathered local systems, and the n_data-wide distance rows of the search
_DIRECT_SYSTEM_ELEMS = 6.7e7
_DIRECT_ROW_ELEMS = 1.5e8


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


def _lane_procs(k_each, device):
    """Process id of each of the sum(k_each) neighborhood lanes."""
    return torch.cat([torch.full((k,), j, dtype=torch.int64, device=device)
                      for j, k in enumerate(k_each)])


def _solve_local(params, a, cvec, z, mask, i, dtype):
    """(pred, err, n_nb) of a batch of masked local systems ``a`` w = cvec."""
    c0 = covariance(params, i, torch.zeros(1, dtype=dtype, device=a.device))[0]
    w, solved = spd_solve(a, cvec)
    pred = torch.sum(w * z, dim=1)
    var = c0 - torch.sum(w * cvec, dim=1)
    err = torch.sqrt(torch.clamp_min(var, 0.0))
    n_nb = mask.sum(dim=1)
    ok = (n_nb > 0) & solved
    return torch.where(ok, pred, torch.nan), torch.where(ok, err, torch.nan), n_nb


def _local_predict_batch(params, coords, values, joint_cov, pcoords, max_dist,
                         i, geodesic, k_each, n_valid, dtype, table=None):
    """Local prediction at every row of ``pcoords``: (pred, err, n_nb).
    ``joint_cov=None`` assembles each local system from the gathered
    neighborhood coordinates instead of gathering it from the joint
    covariance (``table``: the parameters' ``pair_table`` for it)."""
    p = len(coords)
    offsets = np.concatenate([[0], np.cumsum([c.shape[0] for c in coords])])[:-1]
    dev = pcoords.device
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

    mask = torch.cat(mask_parts, dim=1)
    m2 = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(mask.shape[1], dtype=dtype, device=dev)
    if joint_cov is None:
        # the same conventions as the joint matrix, from gathered coordinates
        gc = torch.cat([coords[j][idx_local[j]] for j in range(p)], dim=1)
        a = gathered_covariance(
            params, distance_matrix(gc, gc, geodesic), _lane_procs(k_each, dev), table=table
        ).to(dtype)
    else:
        idx = torch.cat([idx_local[j] + int(offsets[j]) for j in range(p)], dim=1)
        a = joint_cov[idx[:, :, None], idx[:, None, :]]
    a = torch.where(m2, a, eye)

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
    return _solve_local(params, a, cvec, z, mask, i, dtype)


def _local_predict_gathered(params, gc, gz, pid, mask, s0, i, geodesic, dtype, table):
    """Local prediction from host-gathered neighborhoods (the kd path):
    ``gc`` (B, K, 2) neighbor coordinates, ``gz`` (B, K) values, ``pid``
    (K,) lane process ids, ``mask`` (B, K) true-neighbor lanes, ``s0``
    (B, 2) locations. True distances, the local covariance
    (``gathered_covariance``, ``table`` the parameters' ``pair_table``) and
    the masked solve as on the device-search path."""
    dvec = distance_matrix(s0[:, None, :], gc, geodesic)[:, 0, :]
    eye = torch.eye(gc.shape[1], dtype=dtype, device=gc.device)
    m2 = mask[:, :, None] & mask[:, None, :]
    a = torch.where(
        m2, gathered_covariance(params, distance_matrix(gc, gc, geodesic), pid,
                                table=table).to(dtype), eye
    )
    cvec = torch.zeros_like(dvec)
    for j in range(params.n_procs):
        cj = covariance(params, i, dvec) if j == i else cross_covariance(params, i, j, dvec)
        cvec = torch.where(pid == j, cj, cvec)
    cvec = cvec * mask
    return _solve_local(params, a, cvec, gz * mask, mask, i, dtype)


class LocalPredictor:
    """OO surface mirroring the reference point Predictor
    (src/point_prediction.py:21-346), on ``device`` (the card unless
    ``device="cpu"``).

    ``materialize_cov=False`` skips the n x n joint data covariance: each
    local system is assembled from its gathered neighborhood coordinates,
    O(n) memory in all (the prediction-side analog of ``estimate.vecchia``).
    ``neighbor_method`` applies to that path: "device" (masked sort over the
    full distance row of each location), "kd" (host kd-trees, the same
    all-within-max_dist neighborhoods, O(log N) per location) or "auto" (kd
    once the padded data outgrow ``KD_AUTO_THRESHOLD``)."""

    #: data size beyond which the direct-assembly path searches with kd-trees
    KD_AUTO_THRESHOLD = 100_000

    def __init__(self, mod, mf, device=None, materialize_cov: bool = True,
                 neighbor_method: str = "auto") -> None:
        if mod.n_procs != mf.n_procs:
            raise ValueError(
                "Number of theoretical processes different from empirical processes."
            )
        if neighbor_method not in ("auto", "device", "kd"):
            raise ValueError(f"unknown neighbor_method {neighbor_method!r}")
        self.device = resolve_device(device)
        self.n_procs = mod.n_procs
        self.mod = mod
        self.mf = mf
        self.params = mod.params.to(device=self.device)
        self.materialize_cov = bool(materialize_cov)
        self.neighbor_method = neighbor_method
        self._trees = None  # built by the first kd query
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
        self.joint_cov = None
        if self.materialize_cov:
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
            self.dtype = self.joint_cov.dtype
        else:
            self.dtype = torch.promote_types(self.params.sigma.dtype, coords[0].dtype)

    def _neighborhood_widths(self, pcoords, max_dist):
        """Per-process K: the largest neighborhood over all locations,
        bucketed (masked lanes make any K >= the true width exact)."""
        kmax = _kmax(pcoords, self._coords, self._n_valid, max_dist, self.mf.geodesic)
        return tuple(
            min(_bucket_pow2(max(int(k), 1)), int(self._coords[j].shape[0]))
            for j, k in enumerate(kmax)
        )

    def _batch_size(self, k_each, n_pred):
        """Locations per batch of local systems. The direct path holds a few
        (B, K, K) buffers and the search's (B, n_data) rows, so both ceilings
        bound it."""
        k_tot = max(sum(k_each), 1)
        if self.materialize_cov:
            return max(1, _BATCH_ELEMS // (k_tot * k_tot))
        n_data = max(int(c.shape[0]) for c in self._coords)
        chunk = max(16, _bucket_pow2(int(_DIRECT_SYSTEM_ELEMS // (k_tot * k_tot))))
        chunk = min(chunk, max(16, _bucket_pow2(int(_DIRECT_ROW_ELEMS // n_data))))
        return min(chunk, _bucket_pow2(n_pred))

    def _embed(self, c):
        """Points in the kd metric: the 3-D unit-sphere embedding for
        geodesic coordinates (chordal distance is monotone in great-circle
        distance, so neighbor sets and radius filters match haversine's),
        raw coordinates otherwise."""
        if self.mf.geodesic:
            from cokriging_tpu_torch.estimate.vecchia import _sphere_embed

            return _sphere_embed(c)
        return np.asarray(c, np.float64)

    def _kd_radius(self, max_dist):
        if self.mf.geodesic:
            half = min(max_dist / (2.0 * EARTH_RADIUS_KM), np.pi / 2)
            return 2.0 * np.sin(half)
        return float(max_dist)

    def _predict_kd(self, p_arr, max_dist, i):
        """Host kd-tree neighborhoods + the gathered local systems on the
        device (``_local_predict_gathered``). Widths come from an exact
        radius count over all locations first, so the k-nearest queries
        never truncate a neighborhood; locations stream through in host
        chunks, so the gathered buffers stay O(chunk K) at any N."""
        from scipy.spatial import cKDTree

        coords_np = [c[:n].cpu().numpy() for c, n in zip(self._coords, self._n_valid)]
        vals_np = [v[:n].cpu().numpy() for v, n in zip(self._values, self._n_valid)]
        if self._trees is None:
            self._trees = [cKDTree(self._embed(c)) for c in coords_np]
        r = self._kd_radius(max_dist)
        q_all = self._embed(p_arr)
        k_each = []
        for j, tree in enumerate(self._trees):
            counts = tree.query_ball_point(q_all, r * (1 + 1e-12), return_length=True,
                                           workers=-1)
            kmax = int(np.max(counts)) if len(counts) else 0
            k_each.append(min(_bucket_pow2(max(kmax, 1)), self._n_valid[j]))
        k_tot = max(sum(k_each), 1)
        pid = _lane_procs(k_each, self.device)
        n_pred = int(p_arr.shape[0])
        dev_chunk = max(16, _bucket_pow2(int(_DIRECT_SYSTEM_ELEMS // (k_tot * k_tot))))
        dev_chunk = min(dev_chunk, _bucket_pow2(max(n_pred, 1)))
        host_chunk = dev_chunk * max(1, 65536 // dev_chunk)
        dt = vals_np[0].dtype
        table = pair_table(self.params, self.device, getattr(torch, np.dtype(dt).name))
        parts = []
        for s in range(0, n_pred, host_chunk):
            q = q_all[s:s + host_chunk]
            gcs, gzs, masks = [], [], []
            for j, tree in enumerate(self._trees):
                k = k_each[j]
                dd, ii = tree.query(q, k=k, workers=-1)
                dd, ii = dd.reshape(len(q), k), ii.reshape(len(q), k)
                ok = dd <= r * (1 + 1e-12)  # also False for inf (k > n_j)
                ii = np.where(ok, ii, 0)
                gcs.append(coords_np[j][ii])
                gzs.append(np.where(ok, vals_np[j][ii], 0.0))
                masks.append(ok)
            host = (np.concatenate(gcs, axis=1).astype(dt), np.concatenate(gzs, axis=1).astype(dt),
                    np.concatenate(masks, axis=1), np.asarray(p_arr[s:s + host_chunk], dt))
            for t in range(0, len(q), dev_chunk):
                gc, gz, mask, s0 = (torch.as_tensor(a[t:t + dev_chunk], device=self.device)
                                    for a in host)
                parts.append(_local_predict_gathered(
                    self.params, gc, gz, pid, mask, s0, i, self.mf.geodesic, self.dtype, table
                ))
        return parts

    def __call__(self, i: int, pcoords, max_dist: float = 1e3,
                 postprocess: bool = False) -> LocalPrediction:
        """Cokrige process ``i`` at the (n_pred, 2) ``pcoords``."""
        if postprocess:
            raise NotImplementedError(
                "postprocessing to data scale needs fields built from data frames"
            )
        p_arr = np.atleast_2d(np.asarray(pcoords))
        use_kd = not self.materialize_cov and (
            self.neighbor_method == "kd"
            or (self.neighbor_method == "auto"
                and max(int(c.shape[0]) for c in self._coords) > self.KD_AUTO_THRESHOLD)
        )
        with torch.no_grad():
            if use_kd:
                parts = self._predict_kd(p_arr, max_dist, i)
            else:
                pc = torch.as_tensor(p_arr, dtype=self.dtype, device=self.device)
                k_each = self._neighborhood_widths(pc, max_dist)
                chunk = self._batch_size(k_each, pc.shape[0])
                table = None
                if self.joint_cov is None:
                    table = pair_table(self.params, self.device, self._coords[0].dtype)
                parts = [
                    _local_predict_batch(
                        self.params, self._coords, self._values, self.joint_cov,
                        pc[s : s + chunk], max_dist, i, self.mf.geodesic, k_each,
                        self._n_valid, self.dtype, table,
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
