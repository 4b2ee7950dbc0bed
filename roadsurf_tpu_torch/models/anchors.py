"""Anchor generation and box transform math (detectron2-compatible).

Anchors: one size per FPN level (32..512, reference
detectron2_config_3bands.yaml:51-55), aspect ratios (0.5, 1, 2), offset 0.
Box deltas use the Faster R-CNN (dx, dy, dw, dh) parameterization with
configurable weights (RPN 1,1,1,1; box head 10,10,5,5). Anchors are built
in numpy on the host, as in the reference, so both packages produce the
same float32 values."""

from __future__ import annotations

import math

import numpy as np
import torch

# largest sane dw/dh (detectron2 _DEFAULT_SCALE_CLAMP = log(1000/16))
SCALE_CLAMP = math.log(1000.0 / 16.0)


def cell_anchors(size: float, aspect_ratios) -> np.ndarray:
    """(A, 4) XYXY anchors centered at origin, detectron2 parameterization:
    w = sqrt(area/aspect), h = aspect * w."""
    out = []
    area = float(size) ** 2
    for a in aspect_ratios:
        w = math.sqrt(area / a)
        h = a * w
        out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def level_anchors(feat_h: int, feat_w: int, stride: int, size: float,
                  aspect_ratios, offset: float = 0.0) -> np.ndarray:
    """All anchors for one feature level: (H*W*A, 4) XYXY, row-major over
    (y, x, a) matching the (H, W, A*4) head output layout."""
    base = cell_anchors(size, aspect_ratios)        # (A, 4)
    xs = (np.arange(feat_w, dtype=np.float32) + offset) * stride
    ys = (np.arange(feat_h, dtype=np.float32) + offset) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                      axis=-1).reshape(-1, 1, 4)    # (H*W, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def all_level_anchors(image_size: int, strides, sizes, aspect_ratios,
                      offset: float = 0.0) -> list[np.ndarray]:
    out = []
    for stride, size in zip(strides, sizes):
        fh = fw = (image_size + stride - 1) // stride
        out.append(level_anchors(fh, fw, stride, size, aspect_ratios, offset))
    return out


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """deltas (..., 4), boxes (..., 4) XYXY -> decoded XYXY."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=SCALE_CLAMP)

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([
        pred_ctr_x - 0.5 * pred_w,
        pred_ctr_y - 0.5 * pred_h,
        pred_ctr_x + 0.5 * pred_w,
        pred_ctr_y + 0.5 * pred_h,
    ], dim=-1)


def clip_boxes(boxes: torch.Tensor, h: float, w: float) -> torch.Tensor:
    return torch.stack([
        boxes[..., 0].clamp(0, w),
        boxes[..., 1].clamp(0, h),
        boxes[..., 2].clamp(0, w),
        boxes[..., 3].clamp(0, h),
    ], dim=-1)
