"""The PNG tiles the port's own decoder does not take go to Pillow, as the
reference decodes every tile (``roadsurf_tpu_torch/tiles/fetch.py::
decode_image`` against ``roadsurf_tpu/tiles/fetch.py::decode_image``).

Each kind of file, written by Pillow (an interlaced file, which Pillow
does not write, by the Adam7 passes of the PNG specification): an
interlaced RGB file, palette files (``P`` mode, and ``P`` with a
transparency table), 16-bit gray and 16-bit RGB files, a 1-bit gray file
and 4-bit palette file; each decodes in the port to the reference's array,
dtype and shape included, and, where the file holds the image exactly, to
the image. The 8-bit non-interlaced files stay with the port's decoder
(no Pillow needed for them, ``tests/test_torch_tiles.py``).

Tolerances: none; the arrays are equal.
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
from roadsurf_tpu_torch.tiles import fetch as tfetch

torch.set_num_threads(1)

# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def interlaced_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``img`` (H, W, 3) in Adam7 order: each pass's
    sub-image, every row with filter type 0."""
    h, w, _ = img.shape
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub:
            raw.append(0)
            raw += row.tobytes()
    return (tfetch.PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


def _pillow_png(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _header(blob: bytes):
    """(bit depth, colour type, interlace) of a PNG."""
    w, h, depth, colour, _, _, interlace = struct.unpack_from(
        ">IIBBBBB", blob, 16)
    return depth, colour, interlace


def _cases():
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (37, 53, 3), np.uint8)
    idx = rng.integers(0, 200, (40, 24), np.uint8)
    palette = rng.integers(0, 256, 3 * 200, np.uint8).tolist()
    pal = Image.fromarray(idx, mode="L").convert("P")
    pal.putpalette(palette)
    pal_t = pal.copy()
    pal_t.info["transparency"] = 7
    g16 = rng.integers(0, 65536, (21, 19), np.uint16)
    rgb16 = rng.integers(0, 65536, (9, 14, 3), np.uint16)
    bits = Image.fromarray(rng.integers(0, 2, (17, 30), np.uint8) * 255,
                           mode="L").convert("1")
    pal4 = Image.fromarray(rng.integers(0, 16, (12, 10), np.uint8),
                           mode="L").convert("P")
    pal4.putpalette(palette[:48])
    return {
        "interlaced_rgb": (interlaced_png(rgb), rgb, (8, 2, 1)),
        "palette": (_pillow_png(pal), idx[:, :, None], (8, 3, 0)),
        "palette_transparency": (_pillow_png(pal_t), idx[:, :, None],
                                 (8, 3, 0)),
        "palette_4bit": (_pillow_png(pal4, bits=4), None, (4, 3, 0)),
        "gray16": (_pillow_png(Image.fromarray(g16)), None, (16, 0, 0)),
        "rgb16": (_rgb16_png(rgb16), None, (16, 2, 0)),
        "gray1": (_pillow_png(bits), None, (1, 0, 0)),
    }


def _rgb16_png(img: np.ndarray) -> bytes:
    """A 16-bit RGB PNG (Pillow writes no 16-bit RGB): big-endian samples,
    filter type 0."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + row.astype(">u2").tobytes() for row in img)
    return (tfetch.PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_png_decodes_as_the_reference_decodes_it(name):
    blob, image, header = CASES[name]
    assert _header(blob) == header
    assert not tfetch.png_decodes_without_pillow(blob)
    want = jfetch.decode_image(blob)
    got = tfetch.decode_image(blob)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if image is not None:
        np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_ports_decoder_still_refuses_them(name):
    """``decode_png`` itself keeps its limits: ``decode_image`` routes
    these files to Pillow."""
    with pytest.raises(ValueError):
        tfetch.decode_png(CASES[name][0])


def test_8bit_pngs_stay_with_the_ports_decoder(monkeypatch):
    """A Pillow-written 8-bit RGB PNG decodes without Pillow."""
    img = np.random.default_rng(12).integers(0, 256, (16, 16, 3), np.uint8)
    blob = _pillow_png(Image.fromarray(img))
    assert tfetch.png_decodes_without_pillow(blob)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tfetch.decode_image(blob), img)
