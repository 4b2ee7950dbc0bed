"""The polygon value type and Ramer–Douglas–Peucker simplification that
the detection host stage needs.

A slice of the reference package's ``geom/core.py`` (its ``Polygon``
surface, ``_as_ring``, ``_close_ring``, ``_ring_area``, ``rdp_simplify`` and
``rdp_simplify_ring``), operation for operation, in numpy only: the
detections writer's polygons and their WKB bytes come out the same.
Coordinates are float64 arrays; a ring is stored open (no closing point).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


class Polygon:
    """A shell and its holes, each an open (N, 2) float64 ring."""

    geom_type = "Polygon"

    def __init__(self, shell, holes: Sequence | None = None):
        self.exterior_coords = _as_ring(shell)
        self.interiors_coords = [_as_ring(h) for h in (holes or [])]

    @property
    def exterior(self) -> np.ndarray:
        """The shell, closed: (N + 1, 2)."""
        return _close_ring(self.exterior_coords)

    @property
    def interiors(self) -> list[np.ndarray]:
        """The holes, each closed."""
        return [_close_ring(h) for h in self.interiors_coords]

    @property
    def is_empty(self) -> bool:
        return len(self.exterior_coords) < 3

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        c = self.exterior_coords
        if len(c) == 0:
            return (np.nan,) * 4
        return (c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max())

    @property
    def area(self) -> float:
        return abs(_ring_area(self.exterior_coords)) - sum(
            abs(_ring_area(h)) for h in self.interiors_coords)


def _as_ring(shell) -> np.ndarray:
    c = np.asarray(shell, dtype=np.float64)
    if c.ndim == 1:
        c = c.reshape(-1, 2)
    elif c.shape[1] > 2:     # (x, y, z) rings: drop elevations
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


def rdp_simplify(coords: np.ndarray, eps: float) -> np.ndarray:
    """Ramer–Douglas–Peucker polyline simplification (the detections writer
    applies ε = 0.75, config/config_obj_detec.yaml's rdp_simplification)."""
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
    """RDP of a closed ring from its first vertex; returns it open. The
    result depends on where the ring starts."""
    closed = _close_ring(np.asarray(ring, dtype=np.float64))
    out = rdp_simplify(closed, eps)
    return out[:-1] if len(out) > 1 else out
