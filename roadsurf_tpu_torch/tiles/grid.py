"""WebMercatorQuad slippy-map tile grid (a copy of the reference package's
``tiles/grid.py``, itself in place of upstream's morecantile 3.2.5): label
preparation grids the AOI at zoom 18 and emits a GeoJSON feature a tile
whose ``title`` encodes (x, y, z).

The grid math is the OGC TileMatrixSet WebMercatorQuad definition: the
EPSG:3857 square [-R*pi, R*pi]^2 split into 2^z × 2^z tiles, origin top-left.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator

R = 6378137.0
ORIGIN = math.pi * R          # 20037508.342789244
WORLD = 2.0 * ORIGIN


@dataclass(frozen=True)
class Tile:
    x: int
    y: int
    z: int

    def __str__(self):
        return f"Tile(x={self.x}, y={self.y}, z={self.z})"


class WebMercatorQuad:
    """The WebMercatorQuad tile matrix set (EPSG:3857)."""

    identifier = "WebMercatorQuad"
    crs = "EPSG:3857"

    @staticmethod
    def tile_span(z: int) -> float:
        return WORLD / (1 << z)

    # --- coordinate <-> tile ------------------------------------------------

    @classmethod
    def xy_bounds(cls, tile: Tile) -> tuple[float, float, float, float]:
        """(west, south, east, north) of a tile in EPSG:3857."""
        ts = cls.tile_span(tile.z)
        w = -ORIGIN + tile.x * ts
        n = ORIGIN - tile.y * ts
        return (w, n - ts, w + ts, n)

    @classmethod
    def bounds(cls, tile: Tile) -> tuple[float, float, float, float]:
        """(west, south, east, north) of a tile in EPSG:4326 degrees."""
        w, s, e, n = cls.xy_bounds(tile)
        return (cls._merc2lon(w), cls._merc2lat(s),
                cls._merc2lon(e), cls._merc2lat(n))

    @staticmethod
    def _merc2lon(x: float) -> float:
        return math.degrees(x / R)

    @staticmethod
    def _merc2lat(y: float) -> float:
        return math.degrees(2.0 * math.atan(math.exp(y / R)) - math.pi / 2.0)

    @classmethod
    def tile_index(cls, lon: float, lat: float, z: int) -> tuple[int, int]:
        """Fractional-floor tile index containing a 4326 point."""
        n = 1 << z
        x = int(math.floor((lon + 180.0) / 360.0 * n))
        lat_r = math.radians(lat)
        yf = (1.0 - math.asinh(math.tan(lat_r)) / math.pi) / 2.0
        y = int(math.floor(yf * n))
        return (min(max(x, 0), n - 1), min(max(y, 0), n - 1))

    # --- enumeration --------------------------------------------------------

    @classmethod
    def tiles(cls, west: float, south: float, east: float, north: float,
              zooms) -> Iterator[Tile]:
        """All tiles intersecting a 4326 bbox, at the given zoom level(s).

        Matches morecantile/mercantile semantics: the east/north edges are
        nudged inward so a bbox aligned with tile boundaries does not spill
        into the neighbouring tile row/column.
        """
        if isinstance(zooms, int):
            zooms = [zooms]
        eps = 1.0e-11
        for z in zooms:
            x0, y0 = cls.tile_index(west, min(north, 85.051128), z)
            x1, y1 = cls.tile_index(max(east - eps, west),
                                    max(south + eps, -85.051128), z)
            for x in range(x0, x1 + 1):
                for y in range(y0, y1 + 1):
                    yield Tile(x, y, z)

    # --- GeoJSON features ----------------------------------------------------

    @classmethod
    def feature(cls, tile: Tile, projected: bool = False) -> dict:
        """morecantile-compatible GeoJSON feature for a tile.

        The ``title`` property encodes (x, y, z) in a form the pipeline's
        digit-extraction id formatter understands
        (reference prepare_data_obj_detec.py:275-280 strips non-digits from
        the comma-separated parts of ``title``).
        """
        w, s, e, n = cls.xy_bounds(tile) if projected else cls.bounds(tile)
        geom = {
            "type": "Polygon",
            "coordinates": [[(w, s), (w, n), (e, n), (e, s), (w, s)]],
        }
        return {
            "type": "Feature",
            "bbox": [w, s, e, n],
            "id": str(tile),
            "geometry": geom,
            "properties": {
                "title": f"XYZ tile {tile}",
                "grid_name": cls.identifier,
                "grid_crs": cls.crs,
            },
        }

    # --- filenames / ids ------------------------------------------------------

    @staticmethod
    def tile_filename(tile: Tile, ext: str = "tif") -> str:
        """The ``z_x_y.tif`` naming used by the tileset generator (recovered
        in reference statistical_analysis.py:137-141)."""
        return f"{tile.z}_{tile.x}_{tile.y}.{ext}"

    @staticmethod
    def formatted_id(tile: Tile) -> str:
        """'(x, y, z)' id string (reference prepare_data_obj_detec.py:280)."""
        return f"({tile.x}, {tile.y}, {tile.z})"


def tms_get(name: str) -> type[WebMercatorQuad]:
    """morecantile.tms.get equivalent (WebMercatorQuad only)."""
    if name != "WebMercatorQuad":
        raise KeyError(f"unknown TileMatrixSet {name!r}")
    return WebMercatorQuad


def parse_tile_id(tile_id: str) -> Tile:
    """Parse the "(x, y, z)" formatted id back to a Tile."""
    parts = [p.strip() for p in tile_id.strip("() ").split(",")]
    x, y, z = (int(p) for p in parts)
    return Tile(x, y, z)
