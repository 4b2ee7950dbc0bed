"""Minimal GeoTIFF codec for tile imagery.

A copy of the reference package's ``io/geotiff.py`` (stdlib ``struct`` and
``zlib`` + numpy): the tileset generator stores each 256x256 web tile as a
georeferenced ``z_x_y.tif``; the detection host stage reads them back. A
uint8/uint16 striped (or tiled, on read) TIFF with the GeoTIFF tags
ModelPixelScale, ModelTiepoint and a GeoKeyDirectory holding the EPSG
code; uncompressed or zlib (deflate) strips, one planar configuration.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_EXTRA_SAMPLES = 338
_SAMPLE_FORMAT = 339
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735
_NODATA = 42113  # GDAL_NODATA (ascii)

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 12: 8}


@dataclass
class Raster:
    """In-memory raster: HWC uint8/uint16 array + georeferencing."""
    data: np.ndarray                 # (H, W, C)
    origin: tuple[float, float]      # (x, y) of the top-left corner
    pixel_size: tuple[float, float]  # (sx, sy), sy > 0 means north-up
    epsg: int = 3857
    nodata: float | None = None

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        h, w = self.data.shape[:2]
        x0, y0 = self.origin
        sx, sy = self.pixel_size
        return (x0, y0 - sy * h, x0 + sx * w, y0)

    def xy_to_px(self, x, y):
        """World → fractional pixel coords (col, row)."""
        x0, y0 = self.origin
        sx, sy = self.pixel_size
        return (np.asarray(x) - x0) / sx, (y0 - np.asarray(y)) / sy

    def px_to_xy(self, col, row):
        x0, y0 = self.origin
        sx, sy = self.pixel_size
        return x0 + np.asarray(col) * sx, y0 - np.asarray(row) * sy


def write_geotiff(path: str, data: np.ndarray, bounds, epsg: int = 3857,
                  compress: bool = True, nodata: float | None = None) -> None:
    """Write an (H, W, C) or (H, W) uint8/uint16 array as a GeoTIFF with
    ``bounds`` = (west, south, east, north) in the CRS ``epsg``."""
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, c = data.shape
    if data.dtype == np.uint8:
        bps, fmt_np = 8, np.uint8
    elif data.dtype == np.uint16:
        bps, fmt_np = 16, np.uint16
    else:
        raise ValueError(f"unsupported dtype {data.dtype}")
    west, south, east, north = bounds
    sx = (east - west) / w
    sy = (north - south) / h

    raw = np.ascontiguousarray(data.astype(fmt_np)).tobytes()
    strip = zlib.compress(raw, 6) if compress else raw

    entries: list[tuple[int, int, int, bytes]] = []

    def short(v):
        return struct.pack("<HH", v, 0)

    def longv(v):
        return struct.pack("<I", v)

    entries.append((_IMAGE_WIDTH, 3, 1, short(w)))
    entries.append((_IMAGE_LENGTH, 3, 1, short(h)))
    entries.append((_BITS_PER_SAMPLE, 3, c,
                    struct.pack(f"<{c}H", *([bps] * c))))
    entries.append((_COMPRESSION, 3, 1, short(8 if compress else 1)))
    entries.append((_PHOTOMETRIC, 3, 1, short(2 if c >= 3 else 1)))
    entries.append((_STRIP_OFFSETS, 4, 1, longv(0)))      # patched below
    entries.append((_SAMPLES_PER_PIXEL, 3, 1, short(c)))
    entries.append((_ROWS_PER_STRIP, 3, 1, short(h)))
    entries.append((_STRIP_BYTE_COUNTS, 4, 1, longv(len(strip))))
    entries.append((_PLANAR_CONFIG, 3, 1, short(1)))
    if c == 4:
        entries.append((_EXTRA_SAMPLES, 3, 1, short(0)))
    entries.append((_SAMPLE_FORMAT, 3, c, struct.pack(f"<{c}H", *([1] * c))))
    entries.append((_MODEL_PIXEL_SCALE, 12, 3,
                    struct.pack("<3d", sx, sy, 0.0)))
    entries.append((_MODEL_TIEPOINT, 12, 6,
                    struct.pack("<6d", 0, 0, 0, west, north, 0)))
    # GeoKeys: ModelType=Projected(1) | RasterType=PixelIsArea(1) | EPSG
    geokeys = [(1, 1, 0, 4),          # header: version, rev, minor, count
               (1024, 0, 1, 1),
               (1025, 0, 1, 1),
               (3072, 0, 1, epsg),
               (3076, 0, 1, 9001)]    # linear unit: metre
    flat = [v for k in geokeys for v in k]
    flat[3] = len(geokeys) - 1
    entries.append((_GEO_KEY_DIRECTORY, 3, len(flat),
                    struct.pack(f"<{len(flat)}H", *flat)))
    if nodata is not None:
        s = (f"{nodata:g}\x00").encode()
        entries.append((_NODATA, 2, len(s), s))

    entries.sort(key=lambda e: e[0])

    # layout: header(8) + IFD + out-of-line values + strip data
    n = len(entries)
    ifd_size = 2 + n * 12 + 4
    cursor = 8 + ifd_size
    blobs = []
    packed = []
    for tag, typ, count, val in entries:
        size = _TYPE_SIZES[typ] * count
        if size <= 4:
            packed.append((tag, typ, count, val.ljust(4, b"\x00"), None))
        else:
            packed.append((tag, typ, count, struct.pack("<I", cursor), val))
            blobs.append(val)
            cursor += size
    strip_offset = cursor

    out = bytearray()
    out += struct.pack("<2sHI", b"II", 42, 8)
    out += struct.pack("<H", n)
    for tag, typ, count, inline, _ in packed:
        if tag == _STRIP_OFFSETS:
            inline = struct.pack("<I", strip_offset)
        out += struct.pack("<HHI", tag, typ, count) + inline
    out += struct.pack("<I", 0)  # next IFD
    for b in blobs:
        out += b
    out += strip
    with open(path, "wb") as f:
        f.write(out)


def read_geotiff(path: str) -> Raster:
    with open(path, "rb") as f:
        return decode_geotiff(f.read(), path)


def decode_geotiff(buf: bytes, name: str = "<bytes>") -> Raster:
    """A GeoTIFF (or plain TIFF: then the origin is (0, 0), the pixel size
    1 and the EPSG code 3857) held in ``buf``; ``name`` is for errors."""
    order, magic, ifd_off = struct.unpack_from("<2sHI", buf, 0)
    if order != b"II" or magic != 42:
        raise ValueError(f"not a little-endian TIFF: {name}")

    n = struct.unpack_from("<H", buf, ifd_off)[0]
    tags: dict[int, tuple[int, int, bytes]] = {}
    for i in range(n):
        off = ifd_off + 2 + i * 12
        tag, typ, count = struct.unpack_from("<HHI", buf, off)
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            val = buf[off + 8:off + 8 + size]
        else:
            ptr = struct.unpack_from("<I", buf, off + 8)[0]
            val = buf[ptr:ptr + size]
        tags[tag] = (typ, count, val)

    def get_ints(tag, default=None):
        if tag not in tags:
            return default
        typ, count, val = tags[tag]
        fmt = {3: "H", 4: "I", 1: "B"}[typ]
        return list(struct.unpack(f"<{count}{fmt}", val))

    w = get_ints(_IMAGE_WIDTH)[0]
    h = get_ints(_IMAGE_LENGTH)[0]
    c = get_ints(_SAMPLES_PER_PIXEL, [1])[0]
    bps = get_ints(_BITS_PER_SAMPLE, [8])[0]
    comp = get_ints(_COMPRESSION, [1])[0]
    dtype = np.uint8 if bps == 8 else np.uint16

    def decomp(blob):
        if comp == 8 or comp == 32946:
            return zlib.decompress(blob)
        if comp != 1:
            raise ValueError(f"unsupported TIFF compression {comp}")
        return blob

    if 322 in tags:  # TileWidth: tiled layout (COG writer output)
        tw = get_ints(322)[0]
        th = get_ints(323)[0]
        offsets = get_ints(324)
        counts = get_ints(325)
        tx = (w + tw - 1) // tw
        data = np.zeros((h, w, c), dtype)
        for ti, (o, cnt) in enumerate(zip(offsets, counts)):
            block = np.frombuffer(decomp(buf[o:o + cnt]),
                                  dtype=dtype).reshape(th, tw, c)
            j, i = divmod(ti, tx)
            ys, xs = j * th, i * tw
            bh, bw = min(th, h - ys), min(tw, w - xs)
            data[ys:ys + bh, xs:xs + bw] = block[:bh, :bw]
    else:
        offsets = get_ints(_STRIP_OFFSETS)
        counts = get_ints(_STRIP_BYTE_COUNTS)
        chunks = [np.frombuffer(decomp(buf[o:o + cnt]), dtype=dtype)
                  for o, cnt in zip(offsets, counts)]
        data = np.concatenate(chunks).reshape(h, w, c)

    sx = sy = 1.0
    west = north = 0.0
    if _MODEL_PIXEL_SCALE in tags:
        sx, sy, _ = struct.unpack("<3d", tags[_MODEL_PIXEL_SCALE][2])
    if _MODEL_TIEPOINT in tags:
        tp = struct.unpack(f"<{tags[_MODEL_TIEPOINT][1]}d",
                           tags[_MODEL_TIEPOINT][2])
        # tiepoint: raster (i, j, k) -> model (x, y, z); origin at pixel 0,0
        west = tp[3] - tp[0] * sx
        north = tp[4] + tp[1] * sy

    epsg = 3857
    if _GEO_KEY_DIRECTORY in tags:
        typ, count, val = tags[_GEO_KEY_DIRECTORY]
        keys = struct.unpack(f"<{count}H", val)
        for k in range(4, len(keys), 4):
            if keys[k] == 3072:
                epsg = keys[k + 3]

    nodata = None
    if _NODATA in tags:
        try:
            nodata = float(tags[_NODATA][2].split(b"\x00")[0])
        except ValueError:
            pass

    return Raster(data=data, origin=(west, north), pixel_size=(sx, sy),
                  epsg=epsg, nodata=nodata)
