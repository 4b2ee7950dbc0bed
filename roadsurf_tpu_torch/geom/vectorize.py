"""Binary mask -> polygons: the vectorizing step of the detection host stage.

A copy of the reference package's ``geom/vectorize.py``. The tracer emits
pixel-exact rectilinear boundaries: every boundary edge between a filled
and an empty pixel becomes a directed segment (interior kept on a
consistent side), segments are linked into closed rings, and each hole is
assigned to its innermost enclosing exterior. RDP then collapses the
staircases.

``_trace_rings`` is the C++ tracer (``geom_trace_mask`` of
``csrc/geomcore.cpp``), a copy of the reference's; only it starts every ring at the reference's vertex and lists
the rings in its order, and RDP on a closed ring depends on its start
vertex, so only it gives the reference's polygons. ``_trace_rings_py`` is the
plain version: the same ring sets, held equal to the C++ tracer's in a
canonical form.
"""

from __future__ import annotations

import numpy as np

from . import _native
from .core import Polygon, rdp_simplify_ring


def _trace_rings(mask: np.ndarray) -> list[np.ndarray]:
    """All boundary rings of a binary mask (C++ tracer): closed (N, 2) float
    arrays in (x = col, y = row) pixel-corner coordinates. Exterior rings
    have positive shoelace area in this y-down frame, holes negative."""
    return _native.trace_mask(mask)


def _trace_rings_py(mask: np.ndarray) -> list[np.ndarray]:
    """Plain Python tracer: the C++ tracer's ring sets, from other start
    vertices and in another order."""
    m = mask.astype(bool)
    if not m.any():
        return []
    H, W = m.shape
    pad = np.zeros((H + 2, W + 2), bool)
    pad[1:-1, 1:-1] = m

    # directed boundary edges, interior on a consistent side:
    #   empty above → (c, r) → (c+1, r)        (+x)
    #   empty below → (c+1, r+1) → (c, r+1)    (−x)
    #   empty left  → (c, r+1) → (c, r)        (−y)
    #   empty right → (c+1, r) → (c+1, r+1)    (+y)
    edges: dict[tuple, list[tuple]] = {}

    def add(a, b):
        edges.setdefault(a, []).append(b)

    rs, cs = np.nonzero(pad[1:-1, 1:-1])
    top = ~pad[rs, cs + 1]
    bot = ~pad[rs + 2, cs + 1]
    left = ~pad[rs + 1, cs]
    right = ~pad[rs + 1, cs + 2]
    for r, c, t, b, l, rt in zip(rs, cs, top, bot, left, right):
        if t:
            add((c, r), (c + 1, r))
        if b:
            add((c + 1, r + 1), (c, r + 1))
        if l:
            add((c, r + 1), (c, r))
        if rt:
            add((c + 1, r), (c + 1, r + 1))

    rings = []
    while edges:
        start = next(iter(edges))
        ring = [start]
        prev_dir = None
        cur = start
        while True:
            outs = edges.get(cur)
            if not outs:
                break
            if len(outs) == 1 or prev_dir is None:
                nxt = outs.pop(0)
            else:
                # checkerboard corner: two outgoing edges; prefer the one
                # turning left w.r.t. the incoming direction so each ring
                # stays simple (no figure-eight merge)
                def turn(d_in, d_out):
                    return d_in[0] * d_out[1] - d_in[1] * d_out[0]
                cands = sorted(
                    range(len(outs)),
                    key=lambda i: turn(prev_dir,
                                       (outs[i][0] - cur[0],
                                        outs[i][1] - cur[1])))
                nxt = outs.pop(cands[0])
            if not outs:
                edges.pop(cur, None)
            prev_dir = (nxt[0] - cur[0], nxt[1] - cur[1])
            cur = nxt
            ring.append(cur)
            if cur == start:
                break
        if len(ring) >= 5 and ring[0] == ring[-1]:
            rings.append(np.asarray(ring, dtype=np.float64))
    return rings


def _ring_area_signed(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]))


def _point_in_ring(pt, ring) -> bool:
    x, y = pt
    xs, ys = ring[:-1, 0], ring[:-1, 1]
    xe, ye = ring[1:, 0], ring[1:, 1]
    cross = (ys > y) != (ye > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = xs + (y - ys) * (xe - xs) / (ye - ys)
    return bool(np.sum(cross & (x < xint)) % 2)


def mask_to_polygons(mask: np.ndarray, transform=None,
                     simplify_eps: float = 0.0,
                     min_area: float = 0.0) -> list[Polygon]:
    """Vectorize a binary mask into polygons.

    transform: optional callable (N, 2) pixel-corner coords -> world coords
      (e.g. the tile's affine). Applied before simplification, so
      ``simplify_eps`` is in world units.
    min_area: drop polygons smaller than this (world units after transform).
    """
    rings = _trace_rings(mask)
    if not rings:
        return []

    exteriors, holes = [], []
    for r in rings:
        (exteriors if _ring_area_signed(r) > 0 else holes).append(r)

    # each hole belongs to its INNERMOST containing exterior (a hole inside
    # an island inside a larger hole must not also punch the outer polygon)
    assigned: dict[int, list] = {i: [] for i in range(len(exteriors))}
    ext_areas = [abs(_ring_area_signed(e)) for e in exteriors]
    for h in holes:
        best, best_area = -1, None
        for i, ext in enumerate(exteriors):
            if _point_in_ring(h[0], ext) and (best_area is None
                                              or ext_areas[i] < best_area):
                best, best_area = i, ext_areas[i]
        if best >= 0:
            assigned[best].append(h)

    out = []
    for ei, ext in enumerate(exteriors):
        my_holes = assigned[ei]
        e = ext if transform is None else transform(ext)
        hs = [h if transform is None else transform(h) for h in my_holes]
        if simplify_eps > 0:
            e = rdp_simplify_ring(e, simplify_eps)
            hs = [rdp_simplify_ring(h, simplify_eps) for h in hs]
            hs = [h for h in hs if len(h) >= 4]
        if len(e) < 4:
            continue
        p = Polygon(e, hs)
        if p.area >= min_area:
            out.append(p)
    return out
