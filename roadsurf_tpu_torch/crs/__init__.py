from .transform import epsg_code, transform_xy

__all__ = ["epsg_code", "transform_xy"]
