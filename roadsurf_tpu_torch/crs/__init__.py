from .transform import CRS, Transformer, crs_equal, epsg_code, transform_xy

__all__ = ["CRS", "Transformer", "crs_equal", "epsg_code", "transform_xy"]
