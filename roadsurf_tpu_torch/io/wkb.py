"""Well-Known Binary encoding of polygons (the GeoPackage blobs' body).

The reference's ``io/wkb.py`` ``dumps`` for a ``Polygon``, byte for byte:
little-endian, type 3, the ring count, then each ring closed as a point
count and its float64 pairs.
"""

from __future__ import annotations

import struct

import numpy as np

from ..geom.core import _close_ring

_PG = 3


def dumps(geom) -> bytes:
    if geom.geom_type != "Polygon":
        raise TypeError(f"cannot encode {geom.geom_type}")
    rings = [_close_ring(geom.exterior_coords)] + [
        _close_ring(h) for h in geom.interiors_coords]
    out = struct.pack("<BII", 1, _PG, len(rings))
    for r in rings:
        out += struct.pack("<I", len(r))
        out += np.ascontiguousarray(r, "<f8").tobytes()
    return out
