"""Pillow's image resizes, reproduced in numpy without Pillow.

The reference's training loader resizes tiles with Pillow
(``Image.resize(..., BILINEAR)`` for images, ``NEAREST`` for the instance
masks); the port does not depend on Pillow, and the batch must equal
the reference's byte for byte. These functions repeat what Pillow's C code
computes (its ``Resample.c`` and the affine nearest-neighbour scale):

* :func:`resize_bilinear`: a separable triangle filter, horizontal pass
  first, each pass rounding to 8 bits. Per output pixel the filter's
  support widens by the scale when downscaling (support = max(in/out, 1));
  the coefficients are normalized to sum 1 in double precision, then fixed
  to 22 fractional bits (``int(0.5 + k·2²²)``), and each pass sums ``2²¹ +
  Σ pixel·k`` in integers and keeps bits 22..29, clamped to 0..255.
* :func:`resize_nearest`: source position ``x0 = in/out·0.5`` stepped by
  ``in/out`` in double precision (accumulated, as Pillow does) and
  truncated.

Both are held equal to Pillow's output by ``tests/test_torch_train_data.py``
on every size the loader uses.
"""

from __future__ import annotations

import functools

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=64)
def _bilinear_coeffs(in_size: int, out_size: int):
    """(bounds (out, 2): first tap and tap count, fixed-point coefficients
    (out, ksize) int64) of one axis."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        ww = 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            w = 1.0 - t if t < 1.0 else 0.0
            ws.append(w)
            ww += w
        for x, w in enumerate(ws):
            k = w / ww if ww != 0.0 else w
            kk[xx, x] = int(0.5 + k * (1 << _PRECISION_BITS))
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _pass(a: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit pass of the bilinear filter along ``axis`` of uint8
    ``a``."""
    bounds, kk = _bilinear_coeffs(a.shape[axis], out_size)
    ksize = kk.shape[1]
    taps = bounds[:, :1] + np.arange(ksize)[None, :]         # (out, ksize)
    taps = np.minimum(taps, a.shape[axis] - 1)   # unused taps weigh 0
    src = np.moveaxis(a, axis, 0).astype(np.int64)          # (in, ...)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    extra = (1,) * (src.ndim - 1)
    for k in range(ksize):
        acc += src[taps[:, k]] * kk[:, k].reshape((out_size,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.BILINEAR)`` of
    an (H, W) or (H, W, C) uint8 image."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return img.copy()
    out = img
    if W != width:
        out = _pass(out, 1, width)
    if H != height:
        out = _pass(out, 0, height)
    return out


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    a = float(in_size) / out_size
    xo = a * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):
        idx[x] = -1 if xo < 0.0 else int(xo)
        xo += a
    return np.clip(idx, 0, in_size - 1)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.NEAREST)`` of
    an (H, W) uint8 image (or a stack (N, H, W), each resized)."""
    H, W = img.shape[-2:]
    if (H, W) == (height, width):
        return np.array(img, copy=True)
    iy = _nearest_index(H, height)
    ix = _nearest_index(W, width)
    return np.ascontiguousarray(img[..., iy[:, None], ix[None, :]])
