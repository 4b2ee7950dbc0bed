from .core import Polygon, rdp_simplify, rdp_simplify_ring
from .table import DetectionTable
from .vectorize import mask_to_polygons

__all__ = ["Polygon", "rdp_simplify", "rdp_simplify_ring", "DetectionTable",
           "mask_to_polygons"]
