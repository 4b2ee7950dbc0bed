from .geotiff import Raster, read_geotiff, write_geotiff
from .gpkg import write_gpkg

__all__ = ["Raster", "read_geotiff", "write_geotiff", "write_gpkg"]
