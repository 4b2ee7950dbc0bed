"""XYZ/WMTS tile fetching: download web tiles, decode them, write them as
georeferenced GeoTIFFs (a copy of the reference package's
``tiles/fetch.py``): URL templating ``{z}/{x}/{y}``, concurrent download
with a skip-if-exists cache on disk, and fail-fast on the first error.

The reference decodes every tile with Pillow. The port decodes PNG itself
(zlib and numpy: non-interlaced 8-bit gray, gray+alpha, RGB and RGBA, all
five row filters, equal to Pillow's decode byte for byte) and TIFF through
its own GeoTIFF reader, so those tiles need no Pillow; every other PNG
(interlaced, palette, other bit depths) and JPEG go to Pillow, imported
when such a tile arrives, so the port decodes every tile the reference
decodes, to the same array.

``TileFetcher`` takes http(s):// and file:// templates and an ``opener``
(``bytes = opener(url)``) in place of the HTTP opener.
"""

from __future__ import annotations

import concurrent.futures as cf
import io as _io
import os
import struct
import urllib.request
import zlib
from typing import Callable

import numpy as np

from ..io.geotiff import decode_geotiff, write_geotiff
from ..utils.logging import logger
from .grid import Tile, WebMercatorQuad

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # colour type -> samples a pixel


def png_decodes_without_pillow(blob: bytes) -> bool:
    """True for a PNG that :func:`decode_png` takes: not interlaced, 8-bit
    gray, gray+alpha, RGB or RGBA (read from its IHDR chunk)."""
    if blob[:8] != PNG_MAGIC or blob[12:16] != b"IHDR":
        return False
    _, _, depth, colour, _, _, interlace = struct.unpack_from(">IIBBBBB",
                                                              blob, 16)
    return depth == 8 and colour in _PNG_CHANNELS and not interlace


def decode_png(blob: bytes) -> np.ndarray:
    """An 8-bit gray (0), gray+alpha (4), RGB (2) or RGBA (6) PNG as (H, W,
    C) uint8. Other bit depths, palettes and interlaced files raise
    (:func:`decode_image` hands those to Pillow)."""
    if blob[:8] != PNG_MAGIC:
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack_from(">I4s", blob, pos)
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if depth != 8 or colour not in _PNG_CHANNELS:
        raise ValueError(f"PNG of bit depth {depth} and colour type {colour} "
                         "is not supported (8-bit gray, gray+alpha, RGB or "
                         "RGBA only)")
    bpp = _PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(height, 1 + width * bpp)
    pixels = _unfilter(rows[:, 0], rows[:, 1:].reshape(height, width, bpp))
    return pixels


def _unfilter(kinds: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters. Without an Average or Paeth row, a row at a
    time (None, Sub and Up need only the row above); with one, where a byte
    needs the decoded byte to its left, along the image's anti-diagonals:
    every pixel of one depends only on the previous two."""
    if int(kinds.max(initial=0)) > 4:
        raise ValueError(f"bad PNG filter type {int(kinds.max())}")
    h, w, bpp = x.shape
    if int(kinds.max(initial=0)) <= 2:
        out = np.zeros((h + 1, w, bpp), np.int32)     # out[r + 1] is row r
        for r in range(h):
            row = x[r].astype(np.int32)
            if kinds[r] == 1:
                row = np.cumsum(row, axis=0)
            elif kinds[r] == 2:
                row = row + out[r]
            out[r + 1] = row & 0xFF
        return out[1:].astype(np.uint8)
    # skewed layout: pixel (r, c) at s[r + c + 2, r + 1], so each diagonal
    # is a row of s, its left and upper neighbours are slices of the row
    # before and its upper-left neighbour one of the row before that;
    # cells outside the image stay zero, the filters' missing neighbours
    rr, cc = np.indices((h, w))
    xs = np.zeros((h + w + 1, h + 1, bpp), np.int32)
    xs[rr + cc + 2, rr + 1] = x
    s = np.zeros_like(xs)
    sub, up, avg, pae = ((kinds == f)[:, None] for f in (1, 2, 3, 4))
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a = s[d + 1, lo + 1:hi + 1]      # left
        b = s[d + 1, lo:hi]              # up
        c = s[d, lo:hi]                  # upper left
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        pred = np.where(pae[lo:hi],
                        np.where((pa <= pb) & (pa <= pc), a,
                                 np.where(pb <= pc, b, c)),
                        np.where(avg[lo:hi], (a + b) >> 1,
                                 np.where(up[lo:hi], b,
                                          np.where(sub[lo:hi], a, 0))))
        s[d + 2, lo + 1:hi + 1] = (xs[d + 2, lo + 1:hi + 1] + pred) & 0xFF
    return s[rr + cc + 2, rr + 1].astype(np.uint8)


def decode_image(blob: bytes) -> np.ndarray:
    """Decode PNG, TIFF or JPEG bytes to (H, W, C) as the reference's
    Pillow decode does: 8-bit non-interlaced PNG and TIFF without Pillow,
    any other PNG, JPEG (or anything else) with it."""
    if png_decodes_without_pillow(blob):
        return decode_png(blob)
    if blob[:4] == b"II*\x00":
        return decode_geotiff(blob).data
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding a tile that is neither an 8-bit "
                          "non-interlaced PNG nor a little-endian TIFF (e.g. "
                          "JPEG, a palette PNG) needs Pillow, which is not "
                          "installed") from e
    arr = np.asarray(Image.open(_io.BytesIO(blob)))
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class TileFetcher:
    """Fetch XYZ tiles and materialize them as georeferenced GeoTIFFs.

    url_template: e.g. ``https://.../{z}/{x}/{y}.jpeg`` or
    ``file:///cache/{z}/{x}/{y}.png``.
    opener: ``bytes = opener(url)``, in place of the HTTP opener.
    """

    def __init__(self, url_template: str,
                 opener: Callable[[str], bytes] | None = None,
                 n_jobs: int = 10, timeout: float = 30.0):
        self.url_template = url_template
        self.opener = opener or self._default_opener
        self.n_jobs = max(1, n_jobs)
        self.timeout = timeout

    def _default_opener(self, url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=self.timeout) as r:
            return r.read()

    def url_for(self, tile: Tile) -> str:
        return (self.url_template
                .replace("{z}", str(tile.z))
                .replace("{x}", str(tile.x))
                .replace("{y}", str(tile.y)))

    def fetch_array(self, tile: Tile) -> np.ndarray:
        return decode_image(self.opener(self.url_for(tile)))

    def fetch_to_geotiff(self, tile: Tile, path: str,
                         overwrite: bool = False) -> str:
        """Fetch one tile and write it as a GeoTIFF in EPSG:3857, unless
        ``path`` exists and ``overwrite`` is false."""
        if os.path.exists(path) and not overwrite:
            return path
        arr = self.fetch_array(tile)
        bounds = WebMercatorQuad.xy_bounds(tile)
        write_geotiff(path, arr, bounds, epsg=3857)
        return path

    def fetch_many(self, tiles: list[Tile], out_dir: str,
                   overwrite: bool = False,
                   filename: Callable[[Tile], str] | None = None) -> list[str]:
        """Fetch ``tiles`` into ``out_dir`` as ``z_x_y.tif`` on ``n_jobs``
        threads; the first failed tile raises."""
        os.makedirs(out_dir, exist_ok=True)
        name = filename or WebMercatorQuad.tile_filename
        paths = [os.path.join(out_dir, name(t)) for t in tiles]
        with cf.ThreadPoolExecutor(max_workers=self.n_jobs) as ex:
            futs = {ex.submit(self.fetch_to_geotiff, t, p, overwrite): (t, p)
                    for t, p in zip(tiles, paths)}
            for fut in cf.as_completed(futs):
                t, p = futs[fut]
                try:
                    fut.result()
                except Exception as e:
                    logger.error(f"failed to fetch tile {t}: {e}")
                    raise
        return paths
