from .grid import Tile, WebMercatorQuad, parse_tile_id, tms_get

__all__ = ["Tile", "WebMercatorQuad", "parse_tile_id", "tms_get"]
