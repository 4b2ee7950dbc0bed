"""The port's tile grid and fetcher (``roadsurf_tpu_torch/tiles``) against
the reference package's.

* ``WebMercatorQuad.tiles``, ``xy_bounds``, ``bounds``, ``feature`` and
  ``parse_tile_id`` equal the reference's over a Swiss bbox.
* The port decodes PNG itself: 8-bit gray, gray+alpha, RGB and RGBA, each
  row filter (None, Sub, Up, Average, Paeth, and a mix) and Pillow's own
  files, equal to Pillow's decode, also with ``PIL`` blocked; interlaced,
  palette and 16-bit files raise. A TIFF blob decodes to the reference's
  array (Pillow's); a JPEG goes to Pillow and, without it, raises an
  ImportError that names Pillow.
* ``TileFetcher.fetch_many`` with an opener writes GeoTIFFs equal byte for
  byte to the reference's, skips tiles already there and raises on a
  failed tile.
"""

from __future__ import annotations

import io
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from roadsurf_tpu.tiles import fetch as jfetch
from roadsurf_tpu.tiles import grid as jgrid
from roadsurf_tpu_torch.tiles import fetch as tfetch
from roadsurf_tpu_torch.tiles import grid as tgrid

torch.set_num_threads(1)

SWISS = (5.9, 45.8, 10.5, 47.8)          # lon/lat bbox of Switzerland
COLOURS = {1: 0, 2: 4, 3: 2, 4: 6}       # samples a pixel -> colour type


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img: np.ndarray, kinds, interlace: int = 0,
               depth: int = 8, colour: int | None = None) -> bytes:
    """A PNG of ``img`` (H, W, C) uint8, row r filtered with kinds[r %
    len(kinds)], written byte by byte from the PNG specification."""
    h, w, bpp = img.shape
    x = img.astype(int)
    raw = bytearray()
    for r in range(h):
        k = kinds[r % len(kinds)]
        raw.append(k)
        for c in range(w):
            for ch in range(bpp):
                a = x[r, c - 1, ch] if c else 0
                b = x[r - 1, c, ch] if r else 0
                ul = x[r - 1, c - 1, ch] if r and c else 0
                pred = (0, a, b, (a + b) // 2, _paeth(a, b, ul))[k]
                raw.append((x[r, c, ch] - pred) & 0xFF)
    colour = COLOURS[bpp] if colour is None else colour
    return (tfetch.PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                          0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


def _pillow(blob: bytes) -> np.ndarray:
    arr = np.asarray(Image.open(io.BytesIO(blob)))
    return arr[:, :, None] if arr.ndim == 2 else arr


def _block_pillow(mp):
    """Make ``import PIL`` fail, as on a machine without Pillow."""
    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        mp.delitem(sys.modules, name)
    mp.setitem(sys.modules, "PIL", None)


def test_grid_equals_the_reference():
    # Switzerland at zooms 10 to 13, and around Bern at the pipeline's 18
    for z, bbox in ((10, SWISS), (12, SWISS), (13, SWISS),
                    (18, (7.40, 46.90, 7.48, 46.97))):
        jt = list(jgrid.WebMercatorQuad.tiles(*bbox, zooms=[z]))
        tt = list(tgrid.WebMercatorQuad.tiles(*bbox, zooms=[z]))
        assert [(t.x, t.y, t.z) for t in tt] == [(t.x, t.y, t.z) for t in jt]
        assert len(tt) > 50
        for j, t in zip(jt[::7], tt[::7]):
            assert tgrid.WebMercatorQuad.xy_bounds(t) == \
                jgrid.WebMercatorQuad.xy_bounds(j)
            assert tgrid.WebMercatorQuad.bounds(t) == \
                jgrid.WebMercatorQuad.bounds(j)
            for projected in (False, True):
                assert tgrid.WebMercatorQuad.feature(t, projected) == \
                    jgrid.WebMercatorQuad.feature(j, projected)
            tid = tgrid.WebMercatorQuad.formatted_id(t)
            assert tid == jgrid.WebMercatorQuad.formatted_id(j)
            assert tgrid.parse_tile_id(tid) == t
            assert tgrid.WebMercatorQuad.tile_filename(t) == \
                jgrid.WebMercatorQuad.tile_filename(j)
    assert tgrid.tms_get("WebMercatorQuad") is tgrid.WebMercatorQuad


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4],
                                   [0, 3, 4, 4, 1, 2, 3]])
def test_png_decode_equals_pillow(bpp, kinds):
    img = np.random.default_rng(bpp).integers(0, 256, (13, 17, bpp),
                                              dtype=np.uint8)
    blob = encode_png(img, kinds)
    np.testing.assert_array_equal(_pillow(blob), img)
    got = tfetch.decode_image(blob)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_pillow_written_png_decodes_without_pillow(mode, monkeypatch):
    rng = np.random.default_rng(5)
    smooth = np.cumsum(rng.integers(0, 4, (64, 80, len(mode))), 1) % 256
    buf = io.BytesIO()
    Image.fromarray(smooth.astype(np.uint8).squeeze(),
                    mode=mode).save(buf, format="PNG")
    blob = buf.getvalue()
    want = jfetch.decode_image(blob)
    np.testing.assert_array_equal(want, _pillow(blob))
    _block_pillow(monkeypatch)
    np.testing.assert_array_equal(tfetch.decode_image(blob), want)


def test_unsupported_pngs_raise():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="interlaced"):
        tfetch.decode_png(encode_png(img, [0], interlace=1))
    with pytest.raises(ValueError, match="colour type 3"):
        tfetch.decode_png(encode_png(img[:, :, :1], [0], colour=3))
    with pytest.raises(ValueError, match="bit depth 16"):
        tfetch.decode_png(encode_png(img, [0], depth=16))


def test_tiff_blob_decodes_to_the_references_array():
    rng = np.random.default_rng(6)
    for bands in (3, 4):
        img = rng.integers(0, 256, (256, 256, bands), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="TIFF")
        blob = buf.getvalue()
        want = jfetch.decode_image(blob)
        np.testing.assert_array_equal(tfetch.decode_image(blob), want)
        np.testing.assert_array_equal(want, img)


def test_jpeg_goes_to_pillow(monkeypatch):
    img = np.random.default_rng(7).integers(0, 256, (16, 16, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    blob = buf.getvalue()
    np.testing.assert_array_equal(tfetch.decode_image(blob),
                                  jfetch.decode_image(blob))
    _block_pillow(monkeypatch)
    with pytest.raises(ImportError, match="Pillow"):
        tfetch.decode_image(blob)


def _opener(url: str) -> bytes:
    z, x, y = (int(v) for v in url.split("/")[-3:-1] + [
        url.split("/")[-1].split(".")[0]])
    rng = np.random.default_rng(x * 7919 + y)
    img = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    return _png_fast(img, (x + y) % 3)


def _png_fast(img: np.ndarray, kind: int) -> bytes:
    """PNG bytes of ``img``, every row with filter ``kind`` when it is 0
    (None) or 2 (Up), else written by Pillow."""
    if kind in (0, 2):
        h, w, c = img.shape
        rows = img.reshape(h, w * c)
        if kind == 2:
            rows = np.diff(rows, axis=0, prepend=np.zeros((1, w * c),
                                                          np.uint8))
        raw = np.concatenate([np.full((h, 1), kind, np.uint8), rows], 1)
        return (tfetch.PNG_MAGIC
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + _chunk(b"IEND", b""))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_fetch_many_writes_the_references_geotiffs(tmp_path):
    tiles = [tgrid.Tile(136500 + i % 4, 92240 + i // 4, 18)
             for i in range(12)]
    url = "https://tiles.invalid/{z}/{x}/{y}.png"
    port = tfetch.TileFetcher(url, opener=_opener, n_jobs=4)
    ref = jfetch.TileFetcher(url, opener=_opener, n_jobs=4)
    got = port.fetch_many(tiles, str(tmp_path / "port"))
    want = ref.fetch_many([jgrid.Tile(t.x, t.y, t.z) for t in tiles],
                          str(tmp_path / "ref"))
    assert [p.rsplit("/", 1)[1] for p in got] == \
        [p.rsplit("/", 1)[1] for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    # skip-if-exists: an opener that fails is never called
    def fail(url):
        raise OSError(f"no tile at {url}")
    assert tfetch.TileFetcher(url, opener=fail).fetch_many(
        tiles, str(tmp_path / "port")) == got
    with pytest.raises(OSError, match="no tile"):
        tfetch.TileFetcher(url, opener=fail).fetch_many(
            tiles[:2], str(tmp_path / "new"))
