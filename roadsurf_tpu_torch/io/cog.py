"""Cloud-Optimized GeoTIFF writer: tiled, multi-IFD, with overview levels.

A copy of the reference package's ``io/cog.py`` (stdlib ``struct`` and
``zlib`` + numpy), so the same raster gives the same bytes: little-endian
TIFFs with zlib-compressed 256×256 tiles, a full-resolution IFD followed
by AVERAGE-downsampled overview IFDs (GDAL BuildOverviews levels
[2..256]), and GeoTIFF georeferencing on every level. tif2cog
(``pipeline/cog_pipeline.py``) writes its reprojected and its 8-bit
images with it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .geotiff import (_BITS_PER_SAMPLE, _COMPRESSION, _EXTRA_SAMPLES,
                      _GEO_KEY_DIRECTORY, _IMAGE_LENGTH, _IMAGE_WIDTH,
                      _MODEL_PIXEL_SCALE, _MODEL_TIEPOINT, _NODATA,
                      _PHOTOMETRIC, _SAMPLE_FORMAT,
                      _SAMPLES_PER_PIXEL, _TYPE_SIZES)

_NEW_SUBFILE_TYPE = 254
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325

DEFAULT_OVERVIEWS = (2, 4, 8, 16, 32, 64, 128, 256)


def average_downsample(data: np.ndarray, factor: int) -> np.ndarray:
    """AVERAGE-resampled overview (GDAL BuildOverviews 'AVERAGE'),
    edge-padded to a multiple of the factor."""
    h, w, c = data.shape
    oh, ow = (h + factor - 1) // factor, (w + factor - 1) // factor
    ph, pw = oh * factor, ow * factor
    if ph != h or pw != w:
        data = np.pad(data, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    out = data.reshape(oh, factor, ow, factor, c).astype(np.float64)
    return np.round(out.mean(axis=(1, 3))).astype(data.dtype)


def _tile_blobs(data: np.ndarray, tile: int) -> tuple[list[bytes], int, int]:
    h, w, c = data.shape
    tx = (w + tile - 1) // tile
    ty = (h + tile - 1) // tile
    blobs = []
    for j in range(ty):
        for i in range(tx):
            block = np.zeros((tile, tile, c), data.dtype)
            ys, xs = j * tile, i * tile
            sub = data[ys:ys + tile, xs:xs + tile]
            block[:sub.shape[0], :sub.shape[1]] = sub
            blobs.append(zlib.compress(
                np.ascontiguousarray(block).tobytes(), 6))
    return blobs, tx, ty


def write_cog(path: str, data: np.ndarray, bounds, epsg: int = 3857,
              tile: int = 256, overview_levels=DEFAULT_OVERVIEWS,
              nodata: float | None = None) -> None:
    """Write (H, W, C) uint8/uint16 as a tiled GeoTIFF with overviews.

    bounds = (west, south, east, north) in CRS ``epsg``.
    """
    if data.ndim == 2:
        data = data[:, :, None]
    if data.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"unsupported dtype {data.dtype}")
    bps = 8 if data.dtype == np.uint8 else 16
    h, w, c = data.shape
    west, south, east, north = bounds
    sx = (east - west) / w
    sy = (north - south) / h

    # levels: full res + overviews that still have >1 px
    levels = [(1, data)]
    for f in overview_levels:
        if w // f < 1 or h // f < 1:
            break
        levels.append((f, average_downsample(data, f)))

    # per-level tiles
    per_level = []
    for f, arr in levels:
        blobs, tx, ty = _tile_blobs(arr, tile)
        per_level.append({"factor": f, "arr": arr, "blobs": blobs,
                          "tx": tx, "ty": ty})

    geokeys = [1, 1, 0, 4,
               1024, 0, 1, 1,
               1025, 0, 1, 1,
               3072, 0, 1, epsg,
               3076, 0, 1, 9001]

    def build_entries(lvl, is_overview: bool):
        arr = lvl["arr"]
        lh, lw, _ = arr.shape
        n_tiles = len(lvl["blobs"])
        e = []
        if is_overview:
            e.append((_NEW_SUBFILE_TYPE, 4, 1, struct.pack("<I", 1)))
        e.append((_IMAGE_WIDTH, 3, 1, struct.pack("<HH", lw, 0)))
        e.append((_IMAGE_LENGTH, 3, 1, struct.pack("<HH", lh, 0)))
        e.append((_BITS_PER_SAMPLE, 3, c, struct.pack(f"<{c}H",
                                                      *([bps] * c))))
        e.append((_COMPRESSION, 3, 1, struct.pack("<HH", 8, 0)))
        e.append((_PHOTOMETRIC, 3, 1,
                  struct.pack("<HH", 2 if c >= 3 else 1, 0)))
        e.append((_SAMPLES_PER_PIXEL, 3, 1, struct.pack("<HH", c, 0)))
        if c == 4:
            e.append((_EXTRA_SAMPLES, 3, 1, struct.pack("<HH", 0, 0)))
        e.append((_SAMPLE_FORMAT, 3, c, struct.pack(f"<{c}H", *([1] * c))))
        e.append((_TILE_WIDTH, 3, 1, struct.pack("<HH", tile, 0)))
        e.append((_TILE_LENGTH, 3, 1, struct.pack("<HH", tile, 0)))
        e.append((_TILE_OFFSETS, 4, n_tiles, b""))       # patched later
        e.append((_TILE_BYTE_COUNTS, 4, n_tiles,
                  struct.pack(f"<{n_tiles}I",
                              *[len(b) for b in lvl["blobs"]])))
        f = lvl["factor"]
        e.append((_MODEL_PIXEL_SCALE, 12, 3,
                  struct.pack("<3d", sx * f, sy * f, 0.0)))
        e.append((_MODEL_TIEPOINT, 12, 6,
                  struct.pack("<6d", 0, 0, 0, west, north, 0)))
        e.append((_GEO_KEY_DIRECTORY, 3, len(geokeys),
                  struct.pack(f"<{len(geokeys)}H", *geokeys)))
        if nodata is not None:
            s = (f"{nodata:g}\x00").encode()
            e.append((_NODATA, 2, len(s), s))
        e.sort(key=lambda t: t[0])
        return e

    all_entries = [build_entries(lvl, i > 0)
                   for i, lvl in enumerate(per_level)]

    # ---- layout: header | IFD+values per level | tile data ---------------
    cursor = 8
    ifd_meta = []
    for entries in all_entries:
        ifd_offset = cursor
        n = len(entries)
        values_offset = ifd_offset + 2 + n * 12 + 4
        oov = 0  # out-of-line values size
        for tag, typ, count, val in entries:
            size = _TYPE_SIZES[typ] * count
            if size > 4:
                oov += size
        ifd_meta.append({"offset": ifd_offset,
                         "values_offset": values_offset})
        cursor = values_offset + oov
    data_start = cursor

    # tile offsets per level
    tile_cursor = data_start
    for lvl in per_level:
        offs = []
        for b in lvl["blobs"]:
            offs.append(tile_cursor)
            tile_cursor += len(b)
        lvl["tile_offsets"] = offs

    out = bytearray()
    out += struct.pack("<2sHI", b"II", 42, ifd_meta[0]["offset"])
    for li, (entries, meta, lvl) in enumerate(
            zip(all_entries, ifd_meta, per_level)):
        n = len(entries)
        voff = meta["values_offset"]
        chunk = bytearray()
        values = bytearray()
        chunk += struct.pack("<H", n)
        for tag, typ, count, val in entries:
            if tag == _TILE_OFFSETS:
                val = struct.pack(f"<{count}I", *lvl["tile_offsets"])
            size = _TYPE_SIZES[typ] * count
            if size <= 4:
                inline = val.ljust(4, b"\x00")
            else:
                inline = struct.pack("<I", voff + len(values))
                values += val
            chunk += struct.pack("<HHI", tag, typ, count) + inline
        next_ifd = ifd_meta[li + 1]["offset"] if li + 1 < len(ifd_meta) else 0
        chunk += struct.pack("<I", next_ifd)
        out += chunk + values
    assert len(out) == data_start, (len(out), data_start)
    for lvl in per_level:
        for b in lvl["blobs"]:
            out += b
    with open(path, "wb") as f:
        f.write(out)
