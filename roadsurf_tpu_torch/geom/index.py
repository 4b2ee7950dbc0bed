"""Bounding-box spatial index for candidate generation in spatial joins (a
copy of the reference package's ``geom/index.py``).

A uniform grid hash — the datasets here (roads, tiles, labels) are spatially
dense and near-uniform, where a grid beats an R-tree for build time and is
O(1) per probe. Replaces the implicit GEOS STRtree inside geopandas sjoin.
"""

from __future__ import annotations

import numpy as np


class GridIndex:
    def __init__(self, bounds: np.ndarray):
        """bounds: (N, 4) array of (minx, miny, maxx, maxy)."""
        self.bounds = np.asarray(bounds, dtype=np.float64)
        n = len(self.bounds)
        self.n = n
        if n == 0:
            self.cell = 1.0
            self.x0 = self.y0 = 0.0
            self.nx = self.ny = 1
            self.cells: dict[int, list[int]] = {}
            return
        b = self.bounds
        self.x0 = float(np.min(b[:, 0]))
        self.y0 = float(np.min(b[:, 1]))
        x1 = float(np.max(b[:, 2]))
        y1 = float(np.max(b[:, 3]))
        w = np.maximum(b[:, 2] - b[:, 0], 1e-12)
        h = np.maximum(b[:, 3] - b[:, 1], 1e-12)
        # cell ~ median feature size; grid capped at ~4M cells
        self.cell = float(max(np.median(w), np.median(h), 1e-9))
        span_x = max(x1 - self.x0, self.cell)
        span_y = max(y1 - self.y0, self.cell)
        while (span_x / self.cell) * (span_y / self.cell) > 4e6:
            self.cell *= 2.0
        self.nx = int(span_x / self.cell) + 1
        self.ny = int(span_y / self.cell) + 1
        self.cells = {}
        ix0 = ((b[:, 0] - self.x0) / self.cell).astype(np.int64)
        iy0 = ((b[:, 1] - self.y0) / self.cell).astype(np.int64)
        ix1 = ((b[:, 2] - self.x0) / self.cell).astype(np.int64)
        iy1 = ((b[:, 3] - self.y0) / self.cell).astype(np.int64)
        for i in range(n):
            for cx in range(ix0[i], ix1[i] + 1):
                for cy in range(iy0[i], iy1[i] + 1):
                    self.cells.setdefault(cx * self.ny + cy, []).append(i)

    def query(self, minx: float, miny: float, maxx: float, maxy: float) -> np.ndarray:
        """Indices whose bbox intersects the query bbox."""
        if self.n == 0:
            return np.empty(0, dtype=np.int64)
        ix0 = int((minx - self.x0) / self.cell)
        iy0 = int((miny - self.y0) / self.cell)
        ix1 = int((maxx - self.x0) / self.cell)
        iy1 = int((maxy - self.y0) / self.cell)
        ix0, ix1 = max(ix0, 0), min(ix1, self.nx - 1)
        iy0, iy1 = max(iy0, 0), min(iy1, self.ny - 1)
        cand: set[int] = set()
        for cx in range(ix0, ix1 + 1):
            for cy in range(iy0, iy1 + 1):
                lst = self.cells.get(cx * self.ny + cy)
                if lst:
                    cand.update(lst)
        if not cand:
            return np.empty(0, dtype=np.int64)
        idx = np.fromiter(cand, dtype=np.int64)
        b = self.bounds[idx]
        keep = ((b[:, 0] <= maxx) & (b[:, 2] >= minx)
                & (b[:, 1] <= maxy) & (b[:, 3] >= miny))
        return np.sort(idx[keep])
