from .core import (EMPTY, BaseGeometry, GeometryCollection, LineString,
                   MultiLineString, MultiPolygon, Point, Polygon, make_valid,
                   mapping, rdp_simplify, rdp_simplify_ring, shape,
                   unary_union, union_all)
from .table import GeoDataFrame, GeoSeries, overlay, sjoin
from .vectorize import mask_to_polygons
from . import affinity

__all__ = [
    "BaseGeometry", "Point", "LineString", "MultiLineString", "Polygon",
    "MultiPolygon", "GeometryCollection", "EMPTY", "shape", "mapping",
    "union_all", "unary_union", "make_valid", "rdp_simplify",
    "rdp_simplify_ring", "GeoDataFrame", "GeoSeries", "sjoin", "overlay",
    "affinity", "mask_to_polygons",
]
