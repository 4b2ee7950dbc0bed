"""WebMercator (EPSG:3857) <-> WGS84 (EPSG:4326), the one reprojection the
detection host stage makes.

A copy of the reference package's spherical WebMercator formulas and its
``transform_xy`` path for these two codes (through longitude and latitude
in radians), so the same coordinates come out to the bit. Any other EPSG
code raises.
"""

from __future__ import annotations

import numpy as np

SPHERICAL_R = 6378137.0  # web mercator sphere

_D2R = np.pi / 180.0
_R2D = 180.0 / np.pi
_FORTPI = np.pi / 4.0

SUPPORTED = (3857, 4326)


def _webmerc_fwd(lon, lat):
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    x = SPHERICAL_R * lon
    y = SPHERICAL_R * np.log(np.tan(_FORTPI + 0.5 * lat))
    return x, y


def _webmerc_inv(x, y):
    lon = np.asarray(x, dtype=np.float64) / SPHERICAL_R
    lat = 2.0 * (np.arctan(np.exp(np.asarray(y, dtype=np.float64)
                                  / SPHERICAL_R)) - _FORTPI)
    return lon, lat


def epsg_code(crs: int) -> int:
    """The EPSG code ``crs``; raises for a code the port does not
    transform."""
    code = int(crs)
    if code not in SUPPORTED:
        raise ValueError(f"unsupported CRS EPSG:{code} (the port transforms "
                         f"only {SUPPORTED})")
    return code


def _to_wgs84(epsg: int, x, y):
    """-> (lon_rad, lat_rad) on WGS84."""
    if epsg == 4326:
        return np.asarray(x, np.float64) * _D2R, np.asarray(y, np.float64) * _D2R
    return _webmerc_inv(x, y)


def _from_wgs84(epsg: int, lon, lat):
    if epsg == 4326:
        return lon * _R2D, lat * _R2D
    return _webmerc_fwd(lon, lat)


def transform_xy(src, dst, x, y):
    """Transform arrays of coordinates between EPSG:3857 and EPSG:4326."""
    s, d = epsg_code(src), epsg_code(dst)
    if s == d:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    lon, lat = _to_wgs84(s, x, y)
    return _from_wgs84(d, lon, lat)
