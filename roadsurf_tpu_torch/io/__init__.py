"""Vector, raster and tabular I/O. ``read_file``/``write_file`` dispatch on
the extension (or driver) as geopandas' do, as the reference package's
``io/__init__.py`` does."""

from __future__ import annotations

import os

from .geojson import read_geojson, write_geojson
from .geotiff import Raster, decode_geotiff, read_geotiff, write_geotiff
from .gpkg import read_gpkg, write_gpkg
from .shapefile import read_shapefile, write_shapefile
from .xlsx import read_excel, read_xlsx, write_xlsx


def read_file(path: str, layer: str | None = None, driver: str | None = None):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".shp" or driver == "ESRI Shapefile":
        return read_shapefile(path)
    if ext in (".geojson", ".json") or driver == "GeoJSON":
        return read_geojson(path)
    if ext == ".gpkg" or driver == "GPKG":
        return read_gpkg(path, layer=layer)
    raise ValueError(f"unsupported vector format: {path}")


def write_file(gdf, path: str, driver: str | None = None,
               layer: str | None = None) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".shp" or driver == "ESRI Shapefile":
        return write_shapefile(gdf, path)
    if ext in (".geojson", ".json") or driver == "GeoJSON":
        return write_geojson(gdf, path)
    if ext == ".gpkg" or driver == "GPKG":
        return write_gpkg(gdf, path, layer=layer)
    raise ValueError(f"unsupported vector format: {path}")


__all__ = [
    "read_file", "write_file", "read_shapefile", "write_shapefile",
    "read_geojson", "write_geojson", "read_gpkg", "write_gpkg",
    "read_xlsx", "read_excel", "write_xlsx", "Raster", "decode_geotiff",
    "read_geotiff", "write_geotiff",
]
