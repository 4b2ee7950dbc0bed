"""Geometry value types, a shapely-like surface in numpy and the port's C++
core (``_native``).

A copy of the reference package's ``geom/core.py``: ``BaseGeometry``,
``Point``, ``LineString``, ``MultiLineString``, ``Polygon``,
``MultiPolygon``, ``GeometryCollection``, line clipping, ``union_all``,
``make_valid``, ``rdp_simplify``, ``mapping`` and ``shape``, operation for
operation, so the same coordinates come out. Polygon boolean operations,
buffering, containment and rasterization run in ``csrc/geomcore.cpp``;
everything else is numpy. Coordinates are float64 arrays; a ring is stored
open (no closing point).

Two differences from the reference, both shapely's behaviour:

* an empty areal result (a boolean operation, a buffer by a non-positive
  distance, the union of nothing) is an empty ``Polygon``, not an empty
  ``MultiPolygon``;
* ``Polygon.exterior`` and ``Polygon.interiors`` are closed (N + 1, 2)
  arrays (the detection host stage's surface), not ``LineString`` objects.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

from . import _native as N


# ---------------------------------------------------------------------------

class BaseGeometry:
    geom_type = "Unknown"

    # -- subclass hooks ------------------------------------------------------
    def _flat(self) -> N.FlatPolySet:
        """Areal representation for the C++ core (empty for non-areal)."""
        return N.empty_flat()

    @property
    def is_empty(self) -> bool:
        raise NotImplementedError

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        raise NotImplementedError

    @property
    def area(self) -> float:
        return 0.0

    @property
    def length(self) -> float:
        return 0.0

    # -- boolean ops -----------------------------------------------------------
    # Areal×areal runs in the C++ core; line×areal is clipped host-side
    # (the statistical branch clips swissTLM3D road *lines* to the AOI,
    # reference statistical_analysis/prepare_data.py:79).
    def intersection(self, other: "BaseGeometry") -> "BaseGeometry":
        if isinstance(self, _LINEAL) and isinstance(other, _AREAL):
            return _clip_line_to_areal(self, other, keep_inside=True)
        if isinstance(self, _AREAL) and isinstance(other, _LINEAL):
            return _clip_line_to_areal(other, self, keep_inside=True)
        if isinstance(self, Point) and isinstance(other, _AREAL):
            return self if _within(self, other) else EMPTY
        if isinstance(other, Point) and isinstance(self, _AREAL):
            return other if _within(other, self) else EMPTY
        return _from_polys(N.boolean_op(N.OP_INTERSECTION, self._flat(),
                                        other._flat()))

    def union(self, other: "BaseGeometry") -> "BaseGeometry":
        return _from_polys(N.boolean_op(N.OP_UNION, self._flat(),
                                        other._flat()))

    def difference(self, other: "BaseGeometry") -> "BaseGeometry":
        if isinstance(self, _LINEAL) and isinstance(other, _AREAL):
            return _clip_line_to_areal(self, other, keep_inside=False)
        if isinstance(self, _AREAL) and isinstance(other, _LINEAL):
            return self          # lines have zero measure (GEOS semantics)
        return _from_polys(N.boolean_op(N.OP_DIFFERENCE, self._flat(),
                                        other._flat()))

    def symmetric_difference(self, other: "BaseGeometry") -> "BaseGeometry":
        return _from_polys(N.boolean_op(N.OP_XOR, self._flat(), other._flat()))

    def __sub__(self, other):
        return self.difference(other)

    def __and__(self, other):
        return self.intersection(other)

    def __or__(self, other):
        return self.union(other)

    # -- predicates ----------------------------------------------------------
    def _bbox_disjoint(self, other: "BaseGeometry") -> bool:
        if self.is_empty or other.is_empty:
            return True
        a, b = self.bounds, other.bounds
        return a[0] > b[2] or a[2] < b[0] or a[1] > b[3] or a[3] < b[1]

    def intersects(self, other: "BaseGeometry") -> bool:
        if self._bbox_disjoint(other):
            return False
        return _intersects(self, other)

    def within(self, other: "BaseGeometry") -> bool:
        return _within(self, other)

    def contains(self, other: "BaseGeometry") -> bool:
        return _within(other, self)

    def disjoint(self, other: "BaseGeometry") -> bool:
        return not self.intersects(other)

    # -- misc ----------------------------------------------------------------
    @property
    def is_valid(self) -> bool:
        return True

    def equals(self, other: "BaseGeometry") -> bool:
        return self.symmetric_difference(other).area < 1e-12

    def buffer(self, distance: float, cap_style: int = 1,
               quad_segs: int = 8, resolution: int | None = None):
        raise NotImplementedError(
            f"buffer not supported for {self.geom_type}")

    def simplify(self, tolerance: float, preserve_topology: bool = True):
        return self

    @property
    def __geo_interface__(self) -> dict:
        return mapping(self)

    def __repr__(self):
        return f"<{self.geom_type}>"


# ---------------------------------------------------------------------------

class Point(BaseGeometry):
    geom_type = "Point"

    def __init__(self, x, y=None):
        if y is None:
            x, y = x
        self.x = float(x)
        self.y = float(y)

    @property
    def is_empty(self):
        return False

    @property
    def bounds(self):
        return (self.x, self.y, self.x, self.y)

    @property
    def coords(self):
        return [(self.x, self.y)]

    @property
    def centroid(self):
        return self

    def buffer(self, distance, cap_style=1, quad_segs=8, resolution=None):
        if distance <= 0:
            return EMPTY          # shapely semantics: eroding a point
        qs = resolution or quad_segs
        n = max(4, 4 * qs)
        ang = 2 * np.pi * np.arange(n) / n
        ring = np.stack([self.x + distance * np.cos(ang),
                         self.y + distance * np.sin(ang)], axis=1)
        return Polygon(ring)

    def __repr__(self):
        return f"POINT ({self.x} {self.y})"


class LineString(BaseGeometry):
    geom_type = "LineString"

    def __init__(self, coords):
        c = np.asarray(coords, dtype=np.float64)
        if c.ndim != 2:
            c = c.reshape(-1, 2)
        self._coords = c[:, :2].copy()

    @property
    def coords(self):
        return [tuple(p) for p in self._coords]

    @property
    def coords_array(self) -> np.ndarray:
        return self._coords

    @property
    def is_empty(self):
        return len(self._coords) < 2

    @property
    def bounds(self):
        c = self._coords
        return (c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max())

    @property
    def length(self):
        d = np.diff(self._coords, axis=0)
        return float(np.hypot(d[:, 0], d[:, 1]).sum())

    @property
    def centroid(self):
        # length-weighted midpoint average
        c = self._coords
        mids = 0.5 * (c[1:] + c[:-1])
        d = np.diff(c, axis=0)
        w = np.hypot(d[:, 0], d[:, 1])
        if w.sum() == 0:
            return Point(c[0])
        return Point(*(mids * w[:, None]).sum(0) / w.sum())

    def buffer(self, distance, cap_style=1, quad_segs=8, resolution=None):
        """Buffer a polyline. cap_style: 1=round, 2=flat (the label builder
        uses flat caps, reference prepare_data_obj_detec.py:126)."""
        if distance <= 0:
            return EMPTY
        qs = resolution or quad_segs
        return _from_polys(N.buffer_line(self._coords, float(distance),
                                         int(cap_style), int(qs)))

    def simplify(self, tolerance, preserve_topology=True):
        return LineString(rdp_simplify(self._coords, tolerance))


class MultiLineString(BaseGeometry):
    geom_type = "MultiLineString"

    def __init__(self, lines: Iterable):
        self._lines = [l if isinstance(l, LineString) else LineString(l)
                       for l in lines]

    @property
    def geoms(self):
        return self._lines

    @property
    def is_empty(self):
        return all(l.is_empty for l in self._lines)

    @property
    def bounds(self):
        bs = [l.bounds for l in self._lines if not l.is_empty]
        if not bs:
            return (np.nan,) * 4
        bs = np.array(bs)
        return (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())

    @property
    def length(self):
        return sum(l.length for l in self._lines)

    @property
    def centroid(self):
        pts = [l.centroid for l in self._lines if not l.is_empty]
        ws = [l.length for l in self._lines if not l.is_empty]
        tot = sum(ws) or 1.0
        return Point(sum(p.x * w for p, w in zip(pts, ws)) / tot,
                     sum(p.y * w for p, w in zip(pts, ws)) / tot)

    def buffer(self, distance, cap_style=1, quad_segs=8, resolution=None):
        parts = [l.buffer(distance, cap_style, quad_segs) for l in self._lines]
        return union_all([p for p in parts if not p.is_empty])

    def simplify(self, tolerance, preserve_topology=True):
        return MultiLineString([l.simplify(tolerance) for l in self._lines])


class Polygon(BaseGeometry):
    geom_type = "Polygon"

    def __init__(self, shell, holes: Sequence | None = None):
        self.exterior_coords = _as_ring(shell)
        self.interiors_coords = [_as_ring(h) for h in (holes or [])]

    # -- structure -----------------------------------------------------------
    @property
    def exterior(self) -> np.ndarray:
        """The shell, closed: (N + 1, 2)."""
        return _close_ring(self.exterior_coords)

    @property
    def interiors(self) -> list[np.ndarray]:
        """The holes, each closed."""
        return [_close_ring(h) for h in self.interiors_coords]

    @property
    def geoms(self):
        return [self]

    def _rings(self):
        return [self.exterior_coords] + list(self.interiors_coords)

    def _flat(self):
        return N.pack([self._rings()])

    @property
    def is_empty(self):
        return len(self.exterior_coords) < 3

    @property
    def bounds(self):
        c = self.exterior_coords
        if len(c) == 0:
            return (np.nan,) * 4
        return (c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max())

    @property
    def area(self):
        return abs(_ring_area(self.exterior_coords)) - sum(
            abs(_ring_area(h)) for h in self.interiors_coords)

    @property
    def length(self):
        tot = 0.0
        for r in self._rings():
            c = _close_ring(r)
            d = np.diff(c, axis=0)
            tot += float(np.hypot(d[:, 0], d[:, 1]).sum())
        return tot

    @property
    def centroid(self):
        cx = cy = a = 0.0
        for i, r in enumerate(self._rings()):
            ra = _ring_area(r)
            sgn = 1.0 if i == 0 else -1.0
            x, y = r[:, 0], r[:, 1]
            xn, yn = np.roll(x, -1), np.roll(y, -1)
            cross = x * yn - xn * y
            if abs(ra) > 0:
                cx += sgn * np.sum((x + xn) * cross) / 6.0 * np.sign(ra)
                cy += sgn * np.sum((y + yn) * cross) / 6.0 * np.sign(ra)
                a += sgn * abs(ra)
        if a == 0:
            return Point(self.exterior_coords.mean(0))
        return Point(cx / a, cy / a)

    @property
    def is_valid(self):
        # Self-intersection / degenerate-ring check via the native self-union:
        # a valid polygon survives union-with-empty with the same area.
        if self.is_empty:
            return True
        if _ring_self_intersects(self.exterior_coords):
            return False
        for h in self.interiors_coords:
            if _ring_self_intersects(h):
                return False
        return True

    def buffer(self, distance, cap_style=1, quad_segs=8, resolution=None):
        qs = resolution or quad_segs
        if distance >= 0:
            return _from_polys(N.buffer_polygon(self._flat(), float(distance),
                                                int(qs)))
        # negative buffer (erosion): difference with a buffered boundary
        ring = _close_ring(self.exterior_coords)
        edge = LineString(ring).buffer(-distance, cap_style=1, quad_segs=qs)
        out = self.difference(edge)
        for h in self.interiors_coords:
            hr = LineString(_close_ring(h)).buffer(-distance, 1, qs)
            out = out.difference(hr)
        return out

    def simplify(self, tolerance, preserve_topology=True):
        ext = rdp_simplify_ring(self.exterior_coords, tolerance)
        holes = [rdp_simplify_ring(h, tolerance)
                 for h in self.interiors_coords]
        holes = [h for h in holes if len(h) >= 3]
        if len(ext) < 3:
            return Polygon(self.exterior_coords, self.interiors_coords)
        return Polygon(ext, holes)


class MultiPolygon(BaseGeometry):
    geom_type = "MultiPolygon"

    def __init__(self, polygons: Iterable):
        self._polys = [p if isinstance(p, Polygon) else Polygon(*p)
                       for p in polygons]

    @property
    def geoms(self):
        return self._polys

    def _flat(self):
        return N.pack([p._rings() for p in self._polys])

    @property
    def is_empty(self):
        return all(p.is_empty for p in self._polys)

    @property
    def bounds(self):
        bs = [p.bounds for p in self._polys if not p.is_empty]
        if not bs:
            return (np.nan,) * 4
        bs = np.array(bs)
        return (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())

    @property
    def area(self):
        return sum(p.area for p in self._polys)

    @property
    def length(self):
        return sum(p.length for p in self._polys)

    @property
    def centroid(self):
        ws = [p.area for p in self._polys]
        tot = sum(ws)
        if tot == 0:
            return Point(np.mean([p.centroid.x for p in self._polys]),
                         np.mean([p.centroid.y for p in self._polys]))
        cs = [p.centroid for p in self._polys]
        return Point(sum(c.x * w for c, w in zip(cs, ws)) / tot,
                     sum(c.y * w for c, w in zip(cs, ws)) / tot)

    @property
    def is_valid(self):
        return all(p.is_valid for p in self._polys)

    def buffer(self, distance, cap_style=1, quad_segs=8, resolution=None):
        if distance >= 0:
            return _from_polys(N.buffer_polygon(self._flat(), float(distance),
                                                int(resolution or quad_segs)))
        parts = [p.buffer(distance, cap_style, quad_segs)
                 for p in self._polys]
        return union_all(parts)

    def simplify(self, tolerance, preserve_topology=True):
        return MultiPolygon([p.simplify(tolerance) for p in self._polys])


class GeometryCollection(BaseGeometry):
    geom_type = "GeometryCollection"

    def __init__(self, geoms: Iterable = ()):  # minimal support
        self._geoms = list(geoms)

    @property
    def geoms(self):
        return self._geoms

    @property
    def is_empty(self):
        return all(g.is_empty for g in self._geoms)

    @property
    def bounds(self):
        bs = [g.bounds for g in self._geoms if not g.is_empty]
        if not bs:
            return (np.nan,) * 4
        bs = np.array(bs)
        return (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())

    @property
    def area(self):
        return sum(g.area for g in self._geoms)



_LINEAL = (LineString, MultiLineString)
_AREAL = (Polygon, MultiPolygon)


# ---------------------------------------------------------------------------
# line x areal clipping (host-side, vectorized numpy)

def _clip_line_to_areal(line: BaseGeometry, areal: BaseGeometry,
                        keep_inside: bool = True) -> BaseGeometry:
    """Clip a (Multi)LineString against a (Multi)Polygon.

    Splits every line segment at its crossings with the polygon-set edges,
    then classifies each sub-segment by its midpoint (even-odd test in the
    C++ core) and keeps the inside (intersection) or outside (difference)
    chain. Consecutive kept sub-segments are merged back into maximal
    LineStrings. This is the geopandas/GEOS behavior the statistical
    branch relies on when clipping road lines to the AOI
    (reference statistical_analysis/prepare_data.py:79).
    """
    if line.is_empty:
        return MultiLineString([])
    if areal.is_empty:
        return MultiLineString([]) if keep_inside else line

    flat = areal._flat()
    # closed rings of the polygon set, as segment arrays
    polys = areal.geoms if isinstance(areal, MultiPolygon) else [areal]
    ea, eb = [], []
    for p in polys:
        for r in p._rings():
            if len(r) < 3:
                continue
            c = _close_ring(r)
            ea.append(c[:-1])
            eb.append(c[1:])
    if not ea:
        return MultiLineString([]) if keep_inside else line
    ea = np.concatenate(ea)          # (E, 2) edge starts
    eb = np.concatenate(eb)          # (E, 2) edge ends
    ed = eb - ea

    parts: list[np.ndarray] = []
    lines = line.geoms if isinstance(line, MultiLineString) else [line]
    for l in lines:
        c = l.coords_array
        if len(c) < 2:
            continue
        chain: list[np.ndarray] = []    # vertices of the open part
        for i in range(len(c) - 1):
            p, q = c[i], c[i + 1]
            d = q - p
            # crossing parameters t along p->q with every polygon edge
            denom = d[0] * ed[:, 1] - d[1] * ed[:, 0]
            ap = ea - p
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (ap[:, 0] * ed[:, 1] - ap[:, 1] * ed[:, 0]) / denom
                u = (ap[:, 0] * d[1] - ap[:, 1] * d[0]) / denom
            ok = ((denom != 0) & (u >= 0.0) & (u <= 1.0)
                  & (t > 1e-12) & (t < 1 - 1e-12))
            ts = np.unique(np.concatenate(
                [[0.0, 1.0], np.sort(t[ok])])) if np.any(ok) \
                else np.array([0.0, 1.0])
            pts = p + np.outer(ts, d)                 # cut points
            mids = 0.5 * (pts[:-1] + pts[1:])
            inside = N.points_in_polyset(mids, flat).astype(bool)
            keep = inside if keep_inside else ~inside
            for k in range(len(keep)):
                if keep[k]:
                    if not chain:
                        chain = [pts[k], pts[k + 1]]
                    else:
                        chain.append(pts[k + 1])
                elif chain:
                    parts.append(np.array(chain))
                    chain = []
        if chain:
            parts.append(np.array(chain))
            chain = []

    # drop degenerate (zero-length) fragments from touching-point cuts
    parts = [a for a in parts if len(np.unique(a, axis=0)) >= 2]
    if not parts:
        return MultiLineString([])
    if len(parts) == 1:
        return LineString(parts[0])
    return MultiLineString([LineString(a) for a in parts])


# ---------------------------------------------------------------------------
# internals

def _as_ring(shell) -> np.ndarray:
    if isinstance(shell, LineString):
        c = shell.coords_array
    else:
        c = np.asarray(shell, dtype=np.float64)
        if c.ndim == 1:
            c = c.reshape(-1, 2)
        elif c.shape[1] > 2:     # (x, y, z) GeoJSON rings: drop elevations
            c = c[:, :2]
    c = c.copy()
    # drop closing point
    if len(c) > 1 and np.array_equal(c[0], c[-1]):
        c = c[:-1]
    return c


def _close_ring(r: np.ndarray) -> np.ndarray:
    if len(r) == 0:
        return r
    return np.vstack([r, r[:1]])


def _ring_area(r: np.ndarray) -> float:
    if len(r) < 3:
        return 0.0
    x, y = r[:, 0], r[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _ring_self_intersects(r: np.ndarray) -> bool:
    """O(n²) segment crossing test with bbox prefilter (rings are short)."""
    n = len(r)
    if n < 4:
        return False
    c = _close_ring(r)
    a, b = c[:-1], c[1:]
    for i in range(n):
        # non-adjacent segments only
        js = np.arange(i + 2, n if i > 0 else n - 1)
        if len(js) == 0:
            continue
        p, q = a[i], b[i]
        d1 = _cross(q - p, a[js] - p) * _cross(q - p, b[js] - p)
        d2 = (_cross(b[js] - a[js], p - a[js])
              * _cross(b[js] - a[js], q - a[js]))
        if np.any((d1 < 0) & (d2 < 0)):
            return True
    return False


def _cross(u, v):
    u = np.atleast_2d(u)
    v = np.atleast_2d(v)
    return u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]


def _from_polys(polys: list[list[np.ndarray]]) -> BaseGeometry:
    """C++ result -> Polygon / MultiPolygon (shapely-style collapsing; no
    part gives the empty Polygon)."""
    ps = [Polygon(rings[0], rings[1:]) for rings in polys if len(rings[0]) >= 3]
    if not ps:
        return EMPTY
    if len(ps) == 1:
        return ps[0]
    return MultiPolygon(ps)


def _intersects(a: BaseGeometry, b: BaseGeometry) -> bool:
    # areal x areal via native; anything involving lines/points via sampling
    if isinstance(a, (Polygon, MultiPolygon)) and isinstance(b, (Polygon, MultiPolygon)):
        return N.polyset_intersects(a._flat(), b._flat())
    if isinstance(a, Point):
        return bool(N.points_in_polyset(
            np.array([[a.x, a.y]]), b._flat())[0])
    if isinstance(b, Point):
        return _intersects(b, a)
    if isinstance(a, (LineString, MultiLineString)):
        return _line_intersects_poly(a, b)
    if isinstance(b, (LineString, MultiLineString)):
        return _line_intersects_poly(b, a)
    raise TypeError(f"intersects not supported for {a.geom_type} x {b.geom_type}")


def _line_intersects_poly(line, poly) -> bool:
    lines = line.geoms if isinstance(line, MultiLineString) else [line]
    flat = poly._flat()
    for l in lines:
        if np.any(N.points_in_polyset(l.coords_array, flat)):
            return True
        # check segment crossings against polygon rings
        tiny = l.buffer(1e-9, cap_style=2)
        if not tiny.is_empty and N.polyset_intersects(tiny._flat(), flat):
            return True
    return False


def _within(a: BaseGeometry, b: BaseGeometry) -> bool:
    if isinstance(a, Point):
        return bool(N.points_in_polyset(np.array([[a.x, a.y]]), b._flat())[0])
    if isinstance(a, (Polygon, MultiPolygon)) and isinstance(b, (Polygon, MultiPolygon)):
        if a._bbox_disjoint(b):
            return False
        return a.difference(b).area < 1e-9 * max(a.area, 1e-30)
    if isinstance(a, (LineString, MultiLineString)):
        lines = a.geoms if isinstance(a, MultiLineString) else [a]
        flat = b._flat()
        return all(bool(np.all(N.points_in_polyset(l.coords_array, flat)))
                   for l in lines)
    raise TypeError(f"within not supported for {a.geom_type} x {b.geom_type}")


# the empty areal geometry: an empty Polygon, as in shapely
EMPTY = Polygon(np.zeros((0, 2)))


# ---------------------------------------------------------------------------
# module-level operations

def union_all(geoms: Iterable[BaseGeometry]) -> BaseGeometry:
    """Cascaded union (shapely unary_union equivalent)."""
    packs = []
    for g in geoms:
        if g is None or g.is_empty:
            continue
        if isinstance(g, Polygon):
            packs.append(g._rings())
        elif isinstance(g, MultiPolygon):
            packs.extend(p._rings() for p in g._polys)
        else:
            raise TypeError(f"union_all of {g.geom_type}")
    if not packs:
        return EMPTY
    return _from_polys(N.union_many(N.pack(packs)))


unary_union = union_all


def make_valid(g: BaseGeometry) -> BaseGeometry:
    """buffer(0)-style validity repair via native self-union."""
    if isinstance(g, (Polygon, MultiPolygon)):
        return _from_polys(N.buffer_polygon(g._flat(), 0.0, 8))
    return g


def rdp_simplify(coords: np.ndarray, eps: float) -> np.ndarray:
    """Ramer–Douglas–Peucker polyline simplification (the detections writer
    applies ε=0.75, reference config_obj_detec.yaml:87-89)."""
    c = np.asarray(coords, dtype=np.float64)
    n = len(c)
    if n < 3:
        return c.copy()
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 <= i0 + 1:
            continue
        p0, p1 = c[i0], c[i1]
        d = p1 - p0
        nrm = math.hypot(d[0], d[1])
        seg = c[i0 + 1:i1]
        if nrm == 0:
            dist = np.hypot(seg[:, 0] - p0[0], seg[:, 1] - p0[1])
        else:
            dist = np.abs((seg[:, 0] - p0[0]) * d[1]
                          - (seg[:, 1] - p0[1]) * d[0]) / nrm
        imax = int(np.argmax(dist))
        if dist[imax] > eps:
            k = i0 + 1 + imax
            keep[k] = True
            stack.append((i0, k))
            stack.append((k, i1))
    return c[keep]


def rdp_simplify_ring(ring: np.ndarray, eps: float) -> np.ndarray:
    closed = _close_ring(np.asarray(ring, dtype=np.float64))
    out = rdp_simplify(closed, eps)
    return out[:-1] if len(out) > 1 else out


# ---------------------------------------------------------------------------
# GeoJSON-style mapping / shape

def mapping(geom: BaseGeometry) -> dict:
    t = geom.geom_type
    if t == "Point":
        return {"type": "Point", "coordinates": (geom.x, geom.y)}
    if t == "LineString":
        return {"type": "LineString",
                "coordinates": [tuple(p) for p in geom.coords_array]}
    if t == "MultiLineString":
        return {"type": "MultiLineString",
                "coordinates": [[tuple(p) for p in l.coords_array]
                                for l in geom.geoms]}
    if t == "Polygon":
        return {"type": "Polygon", "coordinates": _poly_coords(geom)}
    if t == "MultiPolygon":
        return {"type": "MultiPolygon",
                "coordinates": [_poly_coords(p) for p in geom.geoms]}
    if t == "GeometryCollection":
        return {"type": "GeometryCollection",
                "geometries": [mapping(g) for g in geom.geoms]}
    raise TypeError(f"cannot map {t}")


def _poly_coords(p: Polygon):
    rings = [[tuple(q) for q in _close_ring(p.exterior_coords)]]
    for h in p.interiors_coords:
        rings.append([tuple(q) for q in _close_ring(h)])
    return rings


def shape(obj: dict) -> BaseGeometry:
    t = obj["type"]
    c = obj.get("coordinates")
    if t == "Point":
        return Point(c[0], c[1])     # tolerate (x, y, z)
    if t == "LineString":
        return LineString(c)
    if t == "MultiLineString":
        return MultiLineString([LineString(l) for l in c])
    if t == "Polygon":
        return Polygon(c[0], c[1:])
    if t == "MultiPolygon":
        return MultiPolygon([Polygon(p[0], p[1:]) for p in c])
    if t == "GeometryCollection":
        return GeometryCollection([shape(g) for g in obj["geometries"]])
    raise TypeError(f"cannot build {t}")
