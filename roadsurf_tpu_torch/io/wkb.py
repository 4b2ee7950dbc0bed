"""Well-Known Binary geometry codec, the GeoPackage blobs' body (a copy of
the reference package's ``io/wkb.py``: little-endian ``dumps`` of points,
lines and polygons, and ``loads`` of 2-d, Z, M and ZM geometries, read as
2-d)."""

from __future__ import annotations

import struct

import numpy as np

from ..geom.core import (GeometryCollection, LineString, MultiLineString,
                         MultiPolygon, Point, Polygon, _close_ring)

_PT, _LS, _PG, _MPT, _MLS, _MPG, _GC = 1, 2, 3, 4, 5, 6, 7


def dumps(geom) -> bytes:
    return _enc(geom)


def _enc(g) -> bytes:
    t = g.geom_type
    if t == "Point":
        return struct.pack("<BI2d", 1, _PT, g.x, g.y)
    if t == "LineString":
        c = g.coords_array
        return (struct.pack("<BII", 1, _LS, len(c))
                + np.ascontiguousarray(c, "<f8").tobytes())
    if t == "Polygon":
        rings = [_close_ring(g.exterior_coords)] + [
            _close_ring(h) for h in g.interiors_coords]
        out = struct.pack("<BII", 1, _PG, len(rings))
        for r in rings:
            out += struct.pack("<I", len(r))
            out += np.ascontiguousarray(r, "<f8").tobytes()
        return out
    if t == "MultiLineString":
        out = struct.pack("<BII", 1, _MLS, len(g.geoms))
        return out + b"".join(_enc(l) for l in g.geoms)
    if t == "MultiPolygon":
        out = struct.pack("<BII", 1, _MPG, len(g.geoms))
        return out + b"".join(_enc(p) for p in g.geoms)
    raise TypeError(f"cannot encode {t}")


def loads(buf: bytes):
    g, _ = _dec(buf, 0)
    return g


def _dec(buf: bytes, pos: int):
    byte_order = buf[pos]
    bo = "<" if byte_order == 1 else ">"
    (tcode,) = struct.unpack_from(bo + "I", buf, pos + 1)
    has_z = bool(tcode & 0x80000000) or (1000 <= (tcode % 10000) // 1000 <= 3)
    base = tcode & 0xFF
    if tcode >= 1000:
        base = tcode % 1000
    ndim = 2
    if tcode & 0x80000000:
        ndim += 1
    if tcode & 0x40000000:
        ndim += 1
    if 1000 <= tcode < 2000 or 3000 <= tcode < 4000:
        ndim += 1
    if 2000 <= tcode < 4000:
        ndim += 1
    pos += 5

    def read_pts(n, p):
        a = np.frombuffer(buf, dtype=bo + "f8", count=n * ndim, offset=p)
        return a.reshape(-1, ndim)[:, :2].copy(), p + 8 * n * ndim

    if base == _PT:
        pts, pos = read_pts(1, pos)
        return Point(pts[0, 0], pts[0, 1]), pos
    if base == _LS:
        (n,) = struct.unpack_from(bo + "I", buf, pos)
        pts, pos = read_pts(n, pos + 4)
        return LineString(pts), pos
    if base == _PG:
        (nr,) = struct.unpack_from(bo + "I", buf, pos)
        pos += 4
        rings = []
        for _ in range(nr):
            (n,) = struct.unpack_from(bo + "I", buf, pos)
            pts, pos = read_pts(n, pos + 4)
            rings.append(pts)
        return Polygon(rings[0], rings[1:]), pos
    if base in (_MPT, _MLS, _MPG, _GC):
        (n,) = struct.unpack_from(bo + "I", buf, pos)
        pos += 4
        parts = []
        for _ in range(n):
            g, pos = _dec(buf, pos)
            parts.append(g)
        if base == _MLS:
            return MultiLineString(parts), pos
        if base == _MPG:
            return MultiPolygon(parts), pos
        if base == _MPT:
            return parts[0] if len(parts) == 1 else parts, pos
        return GeometryCollection(parts), pos
    raise TypeError(f"unsupported WKB type {tcode}")
