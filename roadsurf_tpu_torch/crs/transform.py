"""Coordinate transforms between the pipeline's three CRS, from scratch (no
PROJ): EPSG:4326 (WGS84 longitude/latitude), EPSG:3857 (spherical
WebMercator) and EPSG:2056 (CH1903+/LV95: the Swiss oblique Mercator on
the Bessel 1841 ellipsoid, with the official CH1903+ -> WGS84 geocentric
translation (674.374, 15.056, 405.346)).

A copy of the reference package's ``crs/transform.py`` formulas and its
``transform_xy`` path (through WGS84 longitude and latitude in radians),
in float64 numpy, so the same coordinates come out to the bit. The
detection host stage makes 3857 <-> 4326; tif2cog's reprojection 2056 ->
3857 and its inverse map. Any other EPSG code raises.
"""

from __future__ import annotations

import numpy as np

# --- ellipsoids --------------------------------------------------------------

BESSEL_A = 6377397.155
BESSEL_RF = 299.1528128
WGS84_A = 6378137.0
WGS84_RF = 298.257223563
SPHERICAL_R = 6378137.0  # web mercator sphere

# CH1903+ -> WGS84 geocentric translation (EPSG:1676, exact by definition)
CH_DX, CH_DY, CH_DZ = 674.374, 15.056, 405.346

# LV95 projection constants
LV95_LAT0 = np.deg2rad(46.0 + 57.0 / 60.0 + 8.66 / 3600.0)   # 46°57'08.66"N
LV95_LON0 = np.deg2rad(7.0 + 26.0 / 60.0 + 22.50 / 3600.0)   # 7°26'22.50"E
LV95_X0 = 2600000.0  # false easting
LV95_Y0 = 1200000.0  # false northing
LV95_K0 = 1.0

_D2R = np.pi / 180.0
_R2D = 180.0 / np.pi
_FORTPI = np.pi / 4.0
_HALFPI = np.pi / 2.0


def _ellps(a: float, rf: float):
    f = 1.0 / rf
    es = f * (2.0 - f)
    return a, es, np.sqrt(es)


class _Somerc:
    """Swiss oblique mercator (PROJ somerc equivalent) on a given ellipsoid."""

    def __init__(self, a, rf, lat0, lon0, k0, x0, y0):
        self.a, self.es, self.e = _ellps(a, rf)
        self.lon0, self.x0, self.y0 = lon0, x0, y0
        one_es = 1.0 - self.es
        hlf_e = 0.5 * self.e
        cp = np.cos(lat0) ** 2
        self.c = np.sqrt(1.0 + self.es * cp * cp / one_es)
        sp = np.sin(lat0)
        self.sinp0 = sp / self.c
        phip0 = np.arcsin(self.sinp0)
        self.cosp0 = np.cos(phip0)
        spe = sp * self.e
        self.K = (np.log(np.tan(_FORTPI + 0.5 * phip0))
                  - self.c * (np.log(np.tan(_FORTPI + 0.5 * lat0))
                              - hlf_e * np.log((1.0 + spe) / (1.0 - spe))))
        self.kR = k0 * np.sqrt(one_es) / (1.0 - spe * spe)
        self.hlf_e = hlf_e
        self.rone_es = 1.0 / one_es

    def fwd(self, lon, lat):
        lon = np.asarray(lon, dtype=np.float64)
        lat = np.asarray(lat, dtype=np.float64)
        sp = self.e * np.sin(lat)
        phip = (2.0 * np.arctan(np.exp(
            self.c * (np.log(np.tan(_FORTPI + 0.5 * lat))
                      - self.hlf_e * np.log((1.0 + sp) / (1.0 - sp)))
            + self.K)) - _HALFPI)
        lamp = self.c * (lon - self.lon0)
        cp = np.cos(phip)
        phipp = np.arcsin(np.clip(
            self.cosp0 * np.sin(phip) - self.sinp0 * cp * np.cos(lamp),
            -1.0, 1.0))
        lampp = np.arcsin(np.clip(cp * np.sin(lamp) / np.cos(phipp), -1.0, 1.0))
        x = self.a * self.kR * lampp + self.x0
        y = self.a * self.kR * np.log(np.tan(_FORTPI + 0.5 * phipp)) + self.y0
        return x, y

    def inv(self, x, y):
        x = (np.asarray(x, dtype=np.float64) - self.x0) / (self.a * self.kR)
        y = (np.asarray(y, dtype=np.float64) - self.y0) / (self.a * self.kR)
        phipp = 2.0 * (np.arctan(np.exp(y)) - _FORTPI)
        lampp = x
        cp = np.cos(phipp)
        phip = np.arcsin(np.clip(
            self.cosp0 * np.sin(phipp) + self.sinp0 * cp * np.cos(lampp),
            -1.0, 1.0))
        lamp = np.arcsin(np.clip(cp * np.sin(lampp) / np.cos(phip), -1.0, 1.0))
        con = (self.K - np.log(np.tan(_FORTPI + 0.5 * phip))) / self.c
        for _ in range(10):
            esp = self.e * np.sin(phip)
            delp = ((con + np.log(np.tan(_FORTPI + 0.5 * phip))
                     - self.hlf_e * np.log((1.0 + esp) / (1.0 - esp)))
                    * (1.0 - esp * esp) * np.cos(phip) * self.rone_es)
            phip = phip - delp
            if np.all(np.abs(delp) < 1e-14):
                break
        return lamp / self.c + self.lon0, phip


_SOMERC_LV95 = _Somerc(BESSEL_A, BESSEL_RF, LV95_LAT0, LV95_LON0,
                       LV95_K0, LV95_X0, LV95_Y0)


# --- geocentric datum shift ---------------------------------------------------

def _geodetic_to_geocentric(lon, lat, a, rf, h=0.0):
    _, es, _ = _ellps(a, rf)
    sl, cl = np.sin(lat), np.cos(lat)
    n = a / np.sqrt(1.0 - es * sl * sl)
    x = (n + h) * cl * np.cos(lon)
    y = (n + h) * cl * np.sin(lon)
    z = (n * (1.0 - es) + h) * sl
    return x, y, z


def _geocentric_to_geodetic(x, y, z, a, rf):
    _, es, _ = _ellps(a, rf)
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - es))
    for _ in range(8):
        sl = np.sin(lat)
        n = a / np.sqrt(1.0 - es * sl * sl)
        lat = np.arctan2(z + es * n * sl, p)
    return lon, lat


def _bessel_to_wgs84(lon, lat):
    x, y, z = _geodetic_to_geocentric(lon, lat, BESSEL_A, BESSEL_RF)
    return _geocentric_to_geodetic(x + CH_DX, y + CH_DY, z + CH_DZ,
                                   WGS84_A, WGS84_RF)


def _wgs84_to_bessel(lon, lat):
    x, y, z = _geodetic_to_geocentric(lon, lat, WGS84_A, WGS84_RF)
    return _geocentric_to_geodetic(x - CH_DX, y - CH_DY, z - CH_DZ,
                                   BESSEL_A, BESSEL_RF)


SUPPORTED = (2056, 3857, 4326)




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


def epsg_code(crs) -> int:
    """The EPSG code of ``crs`` (an int, an "EPSG:<code>" string or a
    :class:`CRS`); raises for a code the port does not transform."""
    if isinstance(crs, CRS):
        return crs.epsg
    if isinstance(crs, str):
        crs = crs.upper().replace("EPSG:", "")
    code = int(crs)
    if code not in SUPPORTED:
        raise ValueError(f"unsupported CRS EPSG:{code} (the port transforms "
                         f"only {SUPPORTED})")
    return code


class CRS:
    """A CRS keyed by its EPSG code (the reference's ``crs.CRS``): the
    value ``GeoSeries`` and ``GeoDataFrame`` carry."""

    _NAMES = {2056: "EPSG:2056", 3857: "EPSG:3857", 4326: "EPSG:4326"}

    def __init__(self, epsg):
        self.epsg = epsg_code(epsg)

    @classmethod
    def from_user_input(cls, value) -> "CRS":
        return cls(value)

    def to_epsg(self) -> int:
        """pyproj-compatible accessor."""
        return self.epsg

    def __eq__(self, other):
        try:
            return self.epsg == CRS(other).epsg
        except (TypeError, ValueError):
            return NotImplemented

    def __hash__(self):
        return hash(self.epsg)

    def __repr__(self):
        return self._NAMES[self.epsg]

    __str__ = __repr__

    def to_string(self):
        return self._NAMES[self.epsg]

    @property
    def is_geographic(self):
        return self.epsg == 4326


def crs_equal(a, b) -> bool:
    """Whether two CRS inputs name the same CRS; inputs that are no CRS the
    port knows compare by their text."""
    try:
        return CRS(a) == CRS(b)
    except (TypeError, ValueError):
        return str(a) == str(b)


def _to_wgs84(epsg: int, x, y):
    """-> (lon_rad, lat_rad) on WGS84."""
    if epsg == 4326:
        return np.asarray(x, np.float64) * _D2R, np.asarray(y, np.float64) * _D2R
    if epsg == 3857:
        return _webmerc_inv(x, y)
    lon_b, lat_b = _SOMERC_LV95.inv(x, y)
    return _bessel_to_wgs84(lon_b, lat_b)


def _from_wgs84(epsg: int, lon, lat):
    if epsg == 4326:
        return lon * _R2D, lat * _R2D
    if epsg == 3857:
        return _webmerc_fwd(lon, lat)
    lon_b, lat_b = _wgs84_to_bessel(lon, lat)
    return _SOMERC_LV95.fwd(lon_b, lat_b)


def transform_xy(src, dst, x, y):
    """Transform arrays of coordinates between two of EPSG:2056, 3857 and
    4326."""
    s, d = epsg_code(src), epsg_code(dst)
    if s == d:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    lon, lat = _to_wgs84(s, x, y)
    return _from_wgs84(d, lon, lat)


class Transformer:
    """A pyproj.Transformer-alike between two of EPSG:2056, 3857 and 4326,
    in (x, y) order (the reference's ``crs.Transformer``)."""

    def __init__(self, src, dst):
        self.src, self.dst = CRS(src), CRS(dst)

    @classmethod
    def from_crs(cls, src, dst, always_xy: bool = True) -> "Transformer":
        return cls(src, dst)

    def transform(self, x, y):
        return transform_xy(self.src, self.dst, x, y)
