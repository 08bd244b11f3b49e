"""Empirical (cross-)variograms from one two-pass stream over all pairs.

Counterpart of ``cokriging_tpu/estimate/empirical.py``: the device path
(``empirical_variograms_device`` over ``_all_pairs_program``), its entry for
a ``MultiField`` (``empirical_variograms``) and the one-variogram form
(``empirical_variogram_pair``). Every
comparison runs on the monotone distance surrogate h (haversine
sin^2-term, or squared Euclidean distance) built from per-point features by
multiply-adds, with the thresholds moved into h once:

1. min nonzero / max h over the pairs within ``max_dist``;
2. bins centered on linspace(d_min, d_max, n_bins), first edge pulled to 0
   (src/fields.py:389-403), then per-bin cloud sums and pair counts.

On the card both passes run in ``csrc/variogram.cu``
(``kernels.cuda_ops.variogram_minmax_pairs`` / ``variogram_bin_pairs``), one
launch per pass over all the variograms, as ``_all_pairs_program`` is one
program over all of them; on the CPU in their blocked plain torch versions.
The edges are computed on the host, with jnp.linspace's formula, so the two
packages bin alike, but for a pair exactly on an edge: there the edge's last
ulp decides, and XLA's CPU code computes jnp.linspace in another order (it
multiplies by 1 / (n - 1) and reassociates), so on a regular grid, where
such ties are many, a few lattice offsets can fall one bin apart (on
tests/test_trivariate.py's 31 x 31 grid, 12 bins to 0.5: 1,116 pairs of each
marginal variogram, between bins 6 and 7). The h ranges are read once, between the passes.

Conventions preserved exactly: strict-upper-triangle marginal pairs and the
full cross rectangle (src/fields.py:196-203); values centered by their field
means; semivariogram cloud 0.5 (z_i - z_j)^2, covariogram z_i z_j;
right-closed bins; a warning when a bin holds < 30 pairs.
"""

import dataclasses
import warnings
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from cokriging_tpu_torch.kernels.cuda_ops import variogram_bin_pairs, variogram_minmax_pairs
from cokriging_tpu_torch.kernels.distance import ZERO_SNAP, ZERO_SNAP_F32_KM
from cokriging_tpu_torch.utils.config import EARTH_RADIUS_KM, resolve_device


@dataclass(frozen=True)
class VarioConfig:
    """Empirical variogram configuration (src/fields.py:20-46).

    ``geodesic=True`` -> haversine kilometers; ``False`` -> Euclidean.
    """

    max_dist: float
    n_bins: int
    n_procs: int = 2
    kind: str = "Semivariogram"
    geodesic: bool = True

    @property
    def covariogram(self) -> bool:
        return self.kind == "Covariogram"


@dataclass
class EmpiricalVariogram:
    """Binned empirical variograms for all i <= j pairs; row k of the
    stacked (n_pairs, n_bins) arrays belongs to ``pairs[k]``."""

    config: VarioConfig
    pairs: List[tuple]
    bin_centers: np.ndarray
    bin_means: np.ndarray  # NaN where a bin is empty
    bin_counts: np.ndarray
    timestamp: Optional[str] = None
    timedeltas: Optional[List[int]] = None

    @property
    def df(self):
        """The reference's frame (src/fields.py:230-252): index (i, j, bin),
        columns bin_center, bin_mean, bin_count; built with pandas on each
        read."""
        import pandas as pd

        frames = []
        for k, (i, j) in enumerate(self.pairs):
            df = pd.DataFrame({"bin_center": self.bin_centers[k], "bin_mean": self.bin_means[k],
                               "bin_count": self.bin_counts[k], "i": i, "j": j})
            frames.append(df.set_index(["i", "j", df.index]))
        return pd.concat(frames)


def point_features(coords, geodesic):
    """Per-point features that make h a few multiply-adds per pair.

    Geodesic: [sin(lat/2), cos(lat/2), sin(lon/2), cos(lon/2), cos(lat)]
    (radians), so h = sin^2(dlat/2) + cos(lat_a) cos(lat_b) sin^2(dlon/2)
    follows from sin(dx/2) = sin(xa/2) cos(xb/2) - cos(xa/2) sin(xb/2).
    Euclidean: the coordinates themselves.
    """
    if not geodesic:
        return coords.contiguous()
    r = torch.deg2rad(coords)
    hl, hm = 0.5 * r[:, 0], 0.5 * r[:, 1]
    return torch.stack(
        [torch.sin(hl), torch.cos(hl), torch.sin(hm), torch.cos(hm), torch.cos(r[:, 0])],
        dim=1,
    ).contiguous()


def _h_of_d(d, geodesic):
    if geodesic:
        s = np.sin(d / (2.0 * EARTH_RADIUS_KM))
        return s * s
    return d * d


def _d_of_h(h, geodesic):
    if geodesic:
        return 2.0 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))
    return np.sqrt(h)


def _jnp_linspace(start, stop, num, dtype):
    """``jnp.linspace(start, stop, num)`` with jax's formula,
    start * (1 - k/div) + stop * k/div and the endpoint set to stop; numpy's
    own formula can differ in the last ulp and move a pair across an edge."""
    start, stop = dtype.type(start), dtype.type(stop)
    if num == 1:
        return np.array([start], dtype)
    div = num - 1
    step = np.arange(div, dtype=dtype) / dtype.type(div)
    out = start * (dtype.type(1) - step) + stop * step
    return np.concatenate([out, np.array([stop], dtype)])


def _device_bins(hmin, hmax, geodesic, snap, n_bins, dtype):
    """Bin centers and h-edges from the measured h range, as
    ``_all_pairs_program`` builds them (empirical.py:341-361)."""
    with np.errstate(invalid="ignore"):
        dmin = _d_of_h(hmin, geodesic)
        dmax = _d_of_h(hmax, geodesic)
    dmin = dmin if dmin > snap else dtype.type(0)
    dmax = dmax if dmax > snap else dtype.type(0)
    if not (np.isfinite(hmin) and np.isfinite(hmax)):
        dmin = dmax = dtype.type(np.nan)
    centers = _jnp_linspace(dmin, dmax, n_bins, dtype)
    width = centers[1] - centers[0]
    edges = np.concatenate([centers - dtype.type(0.5) * width,
                            centers[-1:] + dtype.type(0.5) * width])
    edges[0] = 0.0
    return centers, _h_of_d(edges, geodesic).astype(dtype)


def _prepare(coords_list, values_list, config: VarioConfig, device):
    """What both passes read, on ``device`` in the first coordinates' float
    dtype: each point set's features, its values centered by their mean
    (src/fields.py:378-381), the numpy dtype, the zero snap in km, and the
    h thresholds of ``max_dist`` and of the snap."""
    dev = resolve_device(device)
    coords = [torch.as_tensor(c).to(dev) for c in coords_list]
    dtype = coords[0].dtype
    coords = [c.to(dtype) for c in coords]
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    values = [torch.as_tensor(v).to(device=dev, dtype=dtype) for v in values_list]
    geodesic = config.geodesic
    snap = ZERO_SNAP_F32_KM if (geodesic and dtype == torch.float32) else ZERO_SNAP
    h_max = float(_h_of_d(np_dtype.type(config.max_dist), geodesic))
    h_snap = float(_h_of_d(np_dtype.type(snap), geodesic))
    feats = [point_features(c, geodesic) for c in coords]
    centered = [(v - v.sum() / v.shape[0]).contiguous() for v in values]
    return feats, centered, np_dtype, snap, h_max, h_snap


def empirical_variograms_device(
    coords_list, values_list, config: VarioConfig, pairs=None, device=None
):
    """All i <= j empirical (cross-)variograms.

    ``coords_list[k]`` is an (n_k, 2) array of [lat, lon] degrees (geodesic)
    or [x, y]; ``values_list[k]`` the (n_k,) values. Runs on ``device``
    (the card unless ``device="cpu"``) in the coordinates' float dtype.

    Returns (pairs, bin_centers, bin_means, bin_counts) with the stacked
    numpy arrays shaped (n_pairs, n_bins); means in the input dtype, counts
    int64.
    """
    p = len(coords_list)
    if pairs is None:
        pairs = [(i, j) for i in range(p) for j in range(p) if i <= j]
    feats, centered, np_dtype, snap, h_max, h_snap = _prepare(coords_list, values_list,
                                                              config, device)
    geodesic = config.geodesic

    # pass 1 over every variogram, then the one host read between the passes
    hrange = variogram_minmax_pairs(
        [(feats[i], feats[j], i == j) for i, j in pairs], geodesic, h_max, h_snap
    ).cpu().numpy()
    bins = [_device_bins(hmin, hmax, geodesic, np_dtype.type(snap), config.n_bins, np_dtype)
            for hmin, hmax in hrange]
    centers = np.stack([c for c, _ in bins])
    if not np.isfinite(centers).all():
        raise ValueError("No pairs within max_dist; cannot build variogram bins.")
    sums, counts = variogram_bin_pairs(
        [(feats[i], feats[j], centered[i], centered[j], i == j) for i, j in pairs],
        [e for _, e in bins], geodesic, config.covariogram, h_max,
    )
    sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
    means = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan).astype(np_dtype)
    if (counts < 30).any():
        warnings.warn(
            "WARNING: Fewer than 30 pairs used for at least one bin in"
            " variogram calculation."
        )
    return pairs, centers, means, counts


def empirical_variograms(mf, config: VarioConfig, device=None) -> EmpiricalVariogram:
    """All i <= j empirical (cross-)variograms of a MultiField's full-grid
    data (src/fields.py:234-252) on ``device`` (the card unless
    ``device="cpu"``): ``empirical_variograms_device``, one launch per pass
    over every variogram. ``config.n_procs`` is set to the number of fields
    (downstream, ``moment_init`` and ``fit_wls`` size the parameter vector
    from it), and the MultiField's timestamp and timedeltas ride along."""
    pairs, centers, means, counts = empirical_variograms_device(
        [f.coords for f in mf.fields], [f.values for f in mf.fields], config, device=device
    )
    if config.n_procs != len(mf.fields):
        config = dataclasses.replace(config, n_procs=len(mf.fields))
    return EmpiricalVariogram(config=config, pairs=pairs, bin_centers=centers,
                              bin_means=means, bin_counts=counts, timestamp=mf.timestamp,
                              timedeltas=mf.timedeltas)


def empirical_variogram_pair(coords_a, values_a, coords_b, values_b, config: VarioConfig,
                             marginal: bool, device=None):
    """One (i, j) binned variogram on ``device`` (the card unless
    ``device="cpu"``): (centers float64, means in the points' dtype, counts
    int64). As the reference's pair form builds them, each side's values are
    centered by their own mean and the bins come from
    ``variogram_bins(d_min, d_max)`` in float64, its edges cast to the
    points' dtype; both passes are ``variogram_minmax_pairs`` /
    ``variogram_bin_pairs`` over the one variogram, one launch each."""
    (fa, fb), centered, np_dtype, _, h_max, h_snap = _prepare(
        [coords_a, coords_b], [values_a, values_b], config, device)
    geodesic = config.geodesic
    hmin, hmax = variogram_minmax_pairs([(fa, fb, marginal)], geodesic, h_max, h_snap)[0].cpu().numpy()
    if not (np.isfinite(hmin) and np.isfinite(hmax)):
        raise ValueError("No pairs within max_dist; cannot build variogram bins.")
    dmin, dmax = (float(_d_of_h(h, geodesic)) for h in (hmin, hmax))
    centers, edges = variogram_bins(dmin, dmax, config.n_bins)
    h_edges = _h_of_d(edges.astype(np_dtype), geodesic).astype(np_dtype)
    sums, counts = variogram_bin_pairs([(fa, fb, *centered, marginal)], [h_edges], geodesic,
                                       config.covariogram, h_max)
    sums, counts = sums[0].cpu().numpy(), counts[0].cpu().numpy()
    means = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan).astype(np_dtype)
    return centers, means, counts


def variogram_bins(min_dist: float, max_dist: float, n_bins: int):
    """Bin centers/edges exactly as the reference constructs them
    (src/fields.py:389-403): centers linspaced [min_dist, max_dist],
    uniform edges straddling them, first edge pulled to zero."""
    centers = np.linspace(min_dist, max_dist, n_bins)
    width = centers[1] - centers[0]
    edges = np.concatenate([centers - 0.5 * width, centers[-1:] + 0.5 * width])
    edges[0] = 0.0
    return centers, edges
