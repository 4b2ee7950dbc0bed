"""Affine transforms (shapely.affinity equivalent subset), a copy of the
reference package's ``geom/affinity.py``.

The pipeline uses ``scale(tile_geometry, xfact=0.99, yfact=0.99)`` to shrink
tiles before clipping labels (reference determine_class.py:83)."""

from __future__ import annotations

import numpy as np

from .core import (BaseGeometry, LineString, MultiLineString, MultiPolygon,
                   Point, Polygon)


def _origin_of(geom: BaseGeometry, origin) -> tuple[float, float]:
    if origin == "center":
        x0, y0, x1, y1 = geom.bounds
        return (0.5 * (x0 + x1), 0.5 * (y0 + y1))
    if origin == "centroid":
        c = geom.centroid
        return (c.x, c.y)
    if isinstance(origin, Point):
        return (origin.x, origin.y)
    return (float(origin[0]), float(origin[1]))


def _apply(geom: BaseGeometry, fn) -> BaseGeometry:
    t = geom.geom_type
    if t == "Point":
        x, y = fn(np.array([[geom.x, geom.y]])).T
        return Point(float(x[0]), float(y[0]))
    if t == "LineString":
        return LineString(fn(geom.coords_array))
    if t == "MultiLineString":
        return MultiLineString([LineString(fn(l.coords_array))
                                for l in geom.geoms])
    if t == "Polygon":
        return Polygon(fn(geom.exterior_coords),
                       [fn(h) for h in geom.interiors_coords])
    if t == "MultiPolygon":
        return MultiPolygon([_apply(p, fn) for p in geom.geoms])
    raise TypeError(f"cannot transform {t}")


def scale(geom: BaseGeometry, xfact: float = 1.0, yfact: float = 1.0,
          origin="center") -> BaseGeometry:
    ox, oy = _origin_of(geom, origin)

    def fn(c):
        c = np.asarray(c, dtype=np.float64)
        out = c.copy()
        out[:, 0] = ox + (c[:, 0] - ox) * xfact
        out[:, 1] = oy + (c[:, 1] - oy) * yfact
        return out

    return _apply(geom, fn)


def translate(geom: BaseGeometry, xoff: float = 0.0, yoff: float = 0.0):
    def fn(c):
        c = np.asarray(c, dtype=np.float64)
        return c + np.array([xoff, yoff])

    return _apply(geom, fn)


def affine_transform(geom: BaseGeometry, matrix) -> BaseGeometry:
    """matrix = [a, b, d, e, xoff, yoff]: x' = a x + b y + xoff."""
    a, b, d, e, xoff, yoff = matrix

    def fn(c):
        c = np.asarray(c, dtype=np.float64)
        return np.stack([a * c[:, 0] + b * c[:, 1] + xoff,
                         d * c[:, 0] + e * c[:, 1] + yoff], axis=1)

    return _apply(geom, fn)
