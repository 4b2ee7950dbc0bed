"""The detections table: plain columns in place of the reference's
``GeoDataFrame`` (a pandas subclass; the port does not use pandas).

Columns are a list of geometries, ``score`` and ``det_class`` numpy arrays,
and an EPSG code. ``write_gpkg`` types each attribute column from its numpy
dtype as the reference's writer types its pandas columns (integer ->
INTEGER, float -> REAL, anything else -> TEXT). The empty table's columns
are float64, as pandas 3 makes the reference's columns from empty lists
(so both are written REAL; pandas 2 made them object, written TEXT).
"""

from __future__ import annotations

import numpy as np

from ..crs import epsg_code, transform_xy
from .core import Polygon


class DetectionTable:
    """Detections as columns: ``geometry`` (list of Polygon), ``score``
    (float64), ``det_class`` (int64), in the CRS ``epsg``."""

    columns = ("geometry", "score", "det_class")

    def __init__(self, geometry: list, score, det_class, epsg: int):
        self.geometry = list(geometry)
        self.score = np.asarray(score)
        self.det_class = np.asarray(det_class)
        self.epsg = epsg_code(epsg)
        if not len(self.geometry) == len(self.score) == len(self.det_class):
            raise ValueError("columns of different lengths")

    @classmethod
    def from_records(cls, records: list[dict], epsg: int) -> "DetectionTable":
        """From {"geometry", "score", "det_class"} records; no records give
        the reference's empty frame (float64 columns)."""
        if not records:
            return cls([], np.array([], np.float64),
                       np.array([], np.float64), epsg)
        return cls([r["geometry"] for r in records],
                   np.array([r["score"] for r in records], np.float64),
                   np.array([r["det_class"] for r in records], np.int64),
                   epsg)

    def __len__(self) -> int:
        return len(self.geometry)

    @property
    def total_bounds(self) -> np.ndarray:
        """(minx, miny, maxx, maxy) over every geometry's bounds."""
        b = np.array([g.bounds for g in self.geometry], np.float64)
        return np.array([np.nanmin(b[:, 0]), np.nanmin(b[:, 1]),
                         np.nanmax(b[:, 2]), np.nanmax(b[:, 3])])

    def to_crs(self, epsg: int) -> "DetectionTable":
        dst = epsg_code(epsg)

        def fn(c):
            x, y = transform_xy(self.epsg, dst, c[:, 0], c[:, 1])
            return np.stack([x, y], axis=1)

        geoms = [Polygon(fn(g.exterior_coords),
                         [fn(h) for h in g.interiors_coords])
                 for g in self.geometry]
        return DetectionTable(geoms, self.score, self.det_class, dst)
