"""Coarse North America land mask, in numpy only.

Counterpart of ``cokriging_tpu/data/landmask.py``: the same polygon set
(one mainland outline plus water exclusions within the CONUS working
extents, lon -125..-65, lat 22..58), tested with an even-odd crossing rule
that decides every point exactly as ``matplotlib.path.Path.contains_points``
does, so both packages mask the same grid cells.
"""

import numpy as np

# Mainland outline, (lon, lat), wound once around; starts on the Mexican
# Pacific coast at ~20N (south of the working extents) and closes via the
# Gulf of Mexico. Top edge runs at 59.5N, above the extents cap of 58N.
_MAINLAND = [
    # Mexico Pacific coast north along the Gulf of California east shore
    (-105.7, 20.0), (-105.4, 21.6), (-106.5, 23.3), (-108.0, 25.0),
    (-109.5, 26.8), (-110.9, 27.9), (-112.3, 29.2), (-113.6, 30.5),
    (-114.7, 31.7),
    # down the Baja east shore to the cape
    (-114.3, 29.9), (-113.1, 28.4), (-111.8, 26.6), (-110.5, 24.5),
    (-109.5, 23.1),
    # up the Baja west coast into California
    (-110.5, 23.8), (-112.1, 24.8), (-113.3, 26.6), (-114.6, 27.8),
    (-115.9, 29.6), (-116.7, 31.6), (-117.1, 32.5),
    # US/Canada Pacific coast
    (-117.5, 33.3), (-118.4, 33.7), (-119.7, 34.4), (-120.6, 34.6),
    (-121.9, 36.6), (-122.5, 37.8), (-123.7, 38.9), (-124.4, 40.4),
    (-124.2, 43.4), (-124.0, 46.2), (-124.7, 48.4), (-123.1, 49.1),
    (-124.8, 50.0), (-126.5, 50.8), (-128.0, 52.2), (-130.2, 54.3),
    (-131.5, 56.4), (-133.5, 58.0), (-135.0, 59.5),
    # across the top (above the 58N extents cap)
    (-100.0, 59.5), (-80.0, 59.5), (-64.0, 59.5),
    # down eastern Quebec to the Gulf of St. Lawrence north shore
    (-64.0, 50.2), (-66.5, 50.2), (-68.6, 49.0), (-70.0, 47.6),
    # cross the St. Lawrence near Quebec City, back along the south shore
    (-71.3, 46.8), (-69.8, 47.5), (-68.4, 48.4), (-67.2, 48.8),
    (-64.4, 48.9),
    # Chaleur Bay, New Brunswick east coast
    (-66.0, 48.0), (-64.9, 47.1), (-64.1, 46.2),
    # Nova Scotia via the Chignecto isthmus
    (-64.2, 45.8), (-63.2, 45.8), (-61.9, 45.6), (-60.0, 46.0),
    (-61.0, 45.3), (-63.5, 44.6), (-65.5, 43.5), (-66.2, 44.0),
    # Bay of Fundy
    (-64.6, 45.3), (-64.5, 45.8), (-65.0, 45.5), (-66.2, 45.1),
    # Maine and the US Atlantic coast
    (-66.9, 44.8), (-68.8, 44.3), (-70.3, 43.6), (-70.8, 42.7),
    (-70.0, 41.8), (-71.5, 41.4), (-72.9, 41.2), (-74.0, 40.6),
    (-74.2, 39.4), (-75.0, 38.4), (-76.0, 37.1), (-75.7, 36.2),
    (-75.5, 35.2), (-76.5, 34.6), (-77.9, 33.9), (-78.9, 33.7),
    (-79.9, 32.8), (-80.8, 32.0), (-81.3, 31.0), (-81.4, 30.4),
    (-80.5, 28.5), (-80.1, 27.2), (-80.0, 26.0), (-80.4, 25.2),
    # around Florida into the Gulf of Mexico
    (-81.1, 25.1), (-81.8, 26.0), (-82.6, 27.8), (-82.8, 29.0),
    (-83.9, 29.9), (-85.3, 29.7), (-86.5, 30.4), (-88.0, 30.3),
    (-89.2, 29.1), (-90.2, 29.1), (-91.5, 29.5), (-93.0, 29.8),
    (-94.5, 29.5), (-95.8, 28.7), (-97.0, 27.8), (-97.3, 26.5),
    (-97.1, 25.9),
    # Mexican Gulf coast south past the extents floor, closing inland
    (-97.6, 24.0), (-97.8, 22.5), (-97.3, 21.3), (-97.0, 20.0),
]

# Water exclusions, (lon, lat)
_HUDSON_JAMES_BAY = [
    (-94.3, 59.4), (-94.2, 58.8), (-93.1, 57.5), (-92.5, 57.0),
    (-89.5, 56.3), (-87.5, 55.8), (-85.5, 55.2), (-82.2, 55.1),
    (-82.3, 53.0), (-80.4, 51.3), (-79.3, 51.1), (-78.9, 52.0),
    (-79.5, 53.5), (-79.2, 54.6), (-77.2, 55.9), (-76.7, 57.2),
    (-78.0, 58.4), (-77.5, 59.4),
]
_LAKE_SUPERIOR = [
    (-92.2, 46.75), (-90.8, 46.6), (-89.6, 46.9), (-88.4, 46.8),
    (-87.0, 46.5), (-85.6, 46.6), (-84.5, 46.5), (-84.4, 46.9),
    (-85.5, 47.6), (-87.3, 48.1), (-89.2, 48.3), (-90.8, 48.1),
    (-92.1, 47.3),
]
_LAKE_MICHIGAN = [
    (-87.5, 41.7), (-87.9, 43.0), (-87.8, 44.3), (-86.9, 45.4),
    (-85.7, 45.9), (-85.0, 45.5), (-86.3, 44.0), (-86.5, 42.5),
    (-86.6, 41.8),
]
_LAKE_HURON = [
    (-82.4, 43.0), (-83.5, 43.9), (-83.9, 43.7), (-83.3, 44.3),
    (-84.6, 45.9), (-84.0, 46.2), (-81.6, 46.0), (-80.1, 44.5),
    (-79.8, 44.8), (-80.0, 44.4), (-81.6, 43.5), (-81.7, 43.0),
]
_LAKE_ERIE = [
    (-83.3, 41.7), (-83.4, 42.1), (-81.5, 42.8), (-79.1, 42.9),
    (-78.9, 42.8), (-80.5, 42.0), (-81.8, 41.5),
]
_LAKE_ONTARIO = [
    (-79.6, 43.2), (-79.0, 43.5), (-76.8, 44.2), (-76.3, 43.9),
    (-77.6, 43.3), (-79.0, 43.2),
]


_WATER = (
    _HUDSON_JAMES_BAY,
    _LAKE_SUPERIOR,
    _LAKE_MICHIGAN,
    _LAKE_HURON,
    _LAKE_ERIE,
    _LAKE_ONTARIO,
)


def points_in_polygon(vertices, x, y):
    """Even-odd test of points (x, y) against the closed polygon
    ``vertices`` [(x, y), ...], with the crossing rule and the arithmetic of
    matplotlib's ``point_in_path``: an edge (x0, y0) -> (x1, y1) toggles a
    point when y0 >= y and y1 >= y differ and
    ((y1 - y) (x0 - x1) >= (x1 - x) (y0 - y1)) equals (y1 >= y)."""
    v = np.asarray(vertices, dtype=float)
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    inside = np.zeros(x.shape, dtype=bool)
    for k in range(len(v)):
        x0, y0 = v[k - 1]
        x1, y1 = v[k]
        flag0 = y0 >= y
        flag1 = y1 >= y
        cross = ((y1 - y) * (x0 - x1) >= (x1 - x) * (y0 - y1)) == flag1
        inside ^= (flag0 != flag1) & cross
    return inside


def land_mask_fn(lat, lon):
    """Boolean land indicator for [lat], [lon] arrays (degrees)."""
    x = np.asarray(lon, dtype=float).ravel()
    y = np.asarray(lat, dtype=float).ravel()
    mask = points_in_polygon(_MAINLAND, x, y)
    for w in _WATER:
        mask &= ~points_in_polygon(w, x, y)
    return mask.reshape(np.shape(lat))
