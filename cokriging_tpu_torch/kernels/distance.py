"""Pairwise distance matrices.

Counterpart of ``cokriging_tpu/kernels/distance.py``: haversine kilometers on
[lat, lon] degrees and Euclidean distances on [x, y], both snapped to exact
zero below a dtype-aware tolerance.
"""

import torch

from cokriging_tpu_torch.utils.config import EARTH_RADIUS_KM

#: Distances below this snap to exact 0, which every exact-zero convention
#: downstream relies on: the nugget only at h == 0 (src/model.py:193-197),
#: LOOCV self-exclusion via d > 0, and the min-nonzero bin anchor.
ZERO_SNAP = 1e-6

#: f32 snap for the geodesic paths: identical f32 coordinates can come out
#: ~1e-3 km apart once deg2rad rounds differently in the row and column
#: operands. 2e-2 km is ~20x above that noise and ~275x below the smallest
#: real grid spacing (5.5 km). Euclidean distances keep the tight snap.
ZERO_SNAP_F32_KM = 2e-2


def _snap(d, tol):
    if tol is None:
        tol = ZERO_SNAP_F32_KM if d.dtype == torch.float32 else ZERO_SNAP
    return torch.where(d > tol, d, 0.0)


def _rows(coords):
    c = torch.as_tensor(coords)
    return c if c.ndim >= 2 else c.reshape(1, -1)


def haversine_matrix(coords1, coords2, radius=EARTH_RADIUS_KM, zero_tol=None):
    """(n, m) great-circle distances in kilometers between (n, 2) and (m, 2)
    [lat, lon] degree rows; matches sklearn ``haversine_distances * R``.
    Leading batch dimensions broadcast: (..., n, 2) and (..., m, 2) give
    (..., n, m). ``zero_tol=None`` selects the dtype-aware snap."""
    c1 = torch.deg2rad(_rows(coords1))
    c2 = torch.deg2rad(_rows(coords2))
    lat1 = c1[..., :, 0:1]
    lat2 = c2[..., :, 0:1].transpose(-1, -2)
    dlat = lat1 - lat2
    dlon = c1[..., :, 1:2] - c2[..., :, 1:2].transpose(-1, -2)
    s = (
        torch.sin(0.5 * dlat) ** 2
        + torch.cos(lat1) * torch.cos(lat2) * torch.sin(0.5 * dlon) ** 2
    )
    s = torch.clamp(s, 0.0, 1.0)
    return _snap(2.0 * radius * torch.arcsin(torch.sqrt(s)), zero_tol)


def euclidean_matrix(coords1, coords2, zero_tol=ZERO_SNAP):
    """(n, m) Euclidean distances from direct coordinate differences
    (exact zeros for identical points); leading batch dimensions broadcast
    as in ``haversine_matrix``."""
    c1 = _rows(coords1)
    c2 = _rows(coords2)
    diff = c1[..., :, None, :] - c2[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return _snap(torch.sqrt(d2), zero_tol)


def distance_matrix(coords1, coords2, geodesic=True):
    """Haversine km on [lat, lon] (``geodesic=True``) or Euclidean."""
    if geodesic:
        return haversine_matrix(coords1, coords2)
    return euclidean_matrix(coords1, coords2)
