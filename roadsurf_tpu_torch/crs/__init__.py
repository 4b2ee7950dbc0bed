from .transform import CRS, crs_equal, epsg_code, transform_xy

__all__ = ["CRS", "crs_equal", "epsg_code", "transform_xy"]
