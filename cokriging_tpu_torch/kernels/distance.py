"""Pairwise distance matrices.

Counterpart of ``cokriging_tpu/kernels/distance.py``: haversine kilometers on
[lat, lon] degrees, the exact ellipsoidal (WGS84, Vincenty) kilometers, and
Euclidean distances on [x, y], all snapped to exact zero below a dtype-aware
tolerance.
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


#: WGS84 ellipsoid (km), the datum of geopy's exact geodesic path
#: (src/fields.py:331-336, ``fast_dist=False``).
WGS84_A_KM = 6378.137
WGS84_F = 1.0 / 298.257223563
WGS84_B_KM = WGS84_A_KM * (1.0 - WGS84_F)


def _vincenty_terms(lam, sin_u1, cos_u1, sin_u2, cos_u2, eps):
    """sin/cos of the angular distance sigma, sigma, sin(alpha),
    cos^2(alpha) and cos(2 sigma_m) at the longitude difference ``lam``."""
    sin_lam, cos_lam = torch.sin(lam), torch.cos(lam)
    sin_sigma = torch.sqrt(
        (cos_u2 * sin_lam) ** 2 + (cos_u1 * sin_u2 - sin_u1 * cos_u2 * cos_lam) ** 2
    )
    cos_sigma = sin_u1 * sin_u2 + cos_u1 * cos_u2 * cos_lam
    sigma = torch.atan2(sin_sigma, cos_sigma)
    sin_alpha = cos_u1 * cos_u2 * sin_lam / torch.clamp_min(sin_sigma, eps)
    cos2_alpha = torch.clamp_min(1.0 - sin_alpha**2, eps)
    cos_2sm = cos_sigma - 2.0 * sin_u1 * sin_u2 / cos2_alpha
    return sin_sigma, cos_sigma, sigma, sin_alpha, cos2_alpha, cos_2sm


def vincenty_matrix(coords1, coords2, n_iter=30, zero_tol=None):
    """(n, m) exact ellipsoidal (WGS84) distances in kilometers between
    [lat, lon] degree rows: Vincenty's inverse formula with a fixed
    ``n_iter``-trip lambda iteration (the reference's slow path,
    ``distance_matrix(..., fast_dist=False)`` via geopy,
    src/fields.py:331-336). Agrees with Karney's algorithm to
    sub-millimeter except near-antipodal pairs, where classic Vincenty does
    not converge."""
    c1 = torch.deg2rad(_rows(coords1))
    c2 = torch.deg2rad(_rows(coords2))
    f = WGS84_F
    u1 = torch.atan((1.0 - f) * torch.tan(c1[:, 0:1]))  # (n, 1) reduced lats
    u2 = torch.atan((1.0 - f) * torch.tan(c2[:, 0:1].T))  # (1, m)
    big_l = c1[:, 1:2] - c2[:, 1:2].T  # (n, m) lon difference
    units = (torch.sin(u1), torch.cos(u1), torch.sin(u2), torch.cos(u2))
    eps = 1e-12
    lam = big_l
    for _ in range(n_iter):
        sin_sigma, cos_sigma, sigma, sin_alpha, cos2_alpha, cos_2sm = _vincenty_terms(
            lam, *units, eps)
        c = f / 16.0 * cos2_alpha * (4.0 + f * (4.0 - 3.0 * cos2_alpha))
        lam_new = big_l + (1.0 - c) * f * sin_alpha * (
            sigma + c * sin_sigma * (cos_2sm + c * cos_sigma * (-1.0 + 2.0 * cos_2sm**2))
        )
        # coincident points: keep lambda fixed (the distance resolves to 0)
        lam = torch.where(sin_sigma < eps, lam, lam_new)

    sin_sigma, cos_sigma, sigma, _, cos2_alpha, cos_2sm = _vincenty_terms(lam, *units, eps)
    u_sq = cos2_alpha * (WGS84_A_KM**2 - WGS84_B_KM**2) / WGS84_B_KM**2
    big_a = 1.0 + u_sq / 16384.0 * (4096.0 + u_sq * (-768.0 + u_sq * (320.0 - 175.0 * u_sq)))
    big_b = u_sq / 1024.0 * (256.0 + u_sq * (-128.0 + u_sq * (74.0 - 47.0 * u_sq)))
    delta_sigma = big_b * sin_sigma * (
        cos_2sm
        + big_b / 4.0 * (
            cos_sigma * (-1.0 + 2.0 * cos_2sm**2)
            - big_b / 6.0 * cos_2sm * (-3.0 + 4.0 * sin_sigma**2) * (-3.0 + 4.0 * cos_2sm**2)
        )
    )
    return _snap(WGS84_B_KM * big_a * (sigma - delta_sigma), zero_tol)


def distance_matrix(coords1, coords2, geodesic=True, exact=False):
    """Haversine km on [lat, lon] (``geodesic=True``; the reference's
    ``fast_dist=True``), the WGS84 Vincenty km with ``exact=True`` as well
    (``fast_dist=False``, src/fields.py:331-336), or Euclidean."""
    if geodesic:
        if exact:
            return vincenty_matrix(coords1, coords2)
        return haversine_matrix(coords1, coords2)
    return euclidean_matrix(coords1, coords2)
