"""ROI heads: FastRCNNConvFCHead (box) + MaskRCNNConvUpsampleHead (mask).

Pinned behavior (reference detectron2_config_3bands.yaml:159-221): box head
ROIAlignV2 7x7 -> 2x FC -> per-class scores and deltas (weights 10,10,5,5);
mask head ROIAlignV2 14x14 -> 4x conv -> 2x deconv -> per-class 28x28
masks. Inference keeps score>=0.05, class-wise NMS, <=D detections per
image. All stages are fixed-shape (padded, masked).

With the static-int8 stack (``models/quant.py``) the box head's FC1 and FC2
and the whole mask head run int8 (``qp``), and the levels may be int8
pyramid levels in per-level scales (``feat_scales``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.nms import NEG_INF, batched_nms_fixed
from ..ops.roi_align import roi_align_multilevel
from .anchors import apply_deltas, clip_boxes
from .quant import _quantize_act, qconv_int8_in, qdeconv_int8_in, qlinear
from .resnet import conv


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Product in the weights' dtype, bias added in float32 (the
    reference's preferred_element_type=f32 dot)."""
    return F.linear(x.to(p["w"].dtype), p["w"]).float() + p["b"].float()


def _pool(feats, boxes, out_size, cfg, feat_scales):
    return roi_align_multilevel(feats, boxes, out_size,
                                sampling=cfg.pooler_sampling_ratio,
                                canonical_size=cfg.canonical_box_size,
                                canonical_level=cfg.canonical_level,
                                feat_scales=feat_scales)


def box_head_forward(params: dict, feats: list, boxes: torch.Tensor, cfg,
                     qp: dict | None = None, feat_scales=None):
    """feats: NHWC (B, H, W, C) levels; boxes (B, R, 4) ->
    (class_logits (B, R, C+1), deltas (B, R, C, 4)), float32.

    The pooled features flatten in (p, q, c) order, the row order of the
    reference's fc1 weight. ``qp``: int8 FC1 and FC2 (the predictors stay
    in the compute dtype); ``feat_scales``: the levels' scales when they
    are int8."""
    B, R = boxes.shape[:2]
    x = _pool(feats, boxes, cfg.box_pooler_resolution, cfg,
              feat_scales).reshape(B * R, -1)
    if qp is not None:
        x = qlinear(x, qp["fc1"], relu=True)
        x = qlinear(x, qp["fc2"], relu=True)
    else:
        x = torch.relu(_linear(x, params["fc1"]))
        x = torch.relu(_linear(x, params["fc2"]))
    logits = _linear(x, params["cls"]).reshape(B, R, -1)
    deltas = _linear(x, params["bbox"]).reshape(B, R, cfg.num_classes, 4)
    return logits, deltas


def mask_head_forward(params: dict, feats: list, boxes: torch.Tensor, cfg,
                      qp: dict | None = None, feat_scales=None):
    """boxes (B, D, 4) -> per-class mask logits (B, D, 2P, 2P, C), float32.

    ``qp``: the int8 conv stream, each conv's epilogue quantizing into the
    next one's scale; with its ``deconv`` and ``predictor`` units the stream
    stays int8 through the deconv into the predictor. ``feat_scales`` as
    for the box head."""
    B, D = boxes.shape[:2]
    P = cfg.mask_pooler_resolution
    dtype = params["conv1"]["w"].dtype
    pooled = _pool(feats, boxes, P, cfg, feat_scales).reshape(B * D, P, P, -1)
    x = pooled.to(dtype).permute(0, 3, 1, 2)       # channels_last NCHW
    if qp is not None:
        n = cfg.mask_num_conv
        tail = "deconv" in qp and "predictor" in qp
        xq = _quantize_act(x.float(), qp["conv1"]["sa"])
        for i in range(n):
            if i + 1 < n:
                sa_out = qp[f"conv{i + 2}"]["sa"]
            else:
                sa_out = qp["deconv"]["sa"] if tail else None
            xq = qconv_int8_in(xq, qp[f"conv{i + 1}"], relu=True,
                               sa_out=sa_out)
        if tail:
            xq = qdeconv_int8_in(xq, qp["deconv"], relu=True,
                                 sa_out=qp["predictor"]["sa"])
            x = qconv_int8_in(xq, qp["predictor"], relu=False).float()
            return x.permute(0, 2, 3, 1).reshape(B, D, 2 * P, 2 * P,
                                                 cfg.num_classes)
        x = xq.to(dtype)                       # bf16 after the last conv
    else:
        for i in range(cfg.mask_num_conv):
            x = torch.relu_(conv(x, params[f"conv{i + 1}"]))
    p = params["deconv"]
    x = torch.relu_(F.conv_transpose2d(x, p["w"], p["b"], stride=2))
    p = params["predictor"]
    x = F.conv2d(x, p["w"]).float() + p["b"].float()[:, None, None]
    return x.permute(0, 2, 3, 1).reshape(B, D, 2 * P, 2 * P,
                                         cfg.num_classes)


def inference_detections(class_logits, deltas, proposals, prop_scores, cfg,
                         image_size: int) -> dict:
    """Per-image fixed-shape detection post-processing.

    class_logits (B, R, C+1), deltas (B, R, C, 4), proposals (B, R, 4).
    Returns boxes (B, D, 4), scores (B, D), classes (B, D) int32 and
    valid (B, D), D = cfg.detections_per_image.
    """
    B, R, Cp1 = class_logits.shape
    C = Cp1 - 1
    scores = torch.softmax(class_logits.float(), dim=-1)[..., :C]
    boxes = apply_deltas(deltas.float(), proposals[:, :, None, :],
                         cfg.box_bbox_weights)
    boxes = clip_boxes(boxes, image_size, image_size)       # (B, R, C, 4)

    valid_prop = prop_scores > NEG_INF / 2
    keep = valid_prop[:, :, None] & (scores >= cfg.score_thresh_test)
    flat_scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF)
                              ).reshape(B, R * C)
    flat_boxes = boxes.reshape(B, R * C, 4)
    flat_classes = torch.arange(C, dtype=torch.int32,
                                device=scores.device).repeat(B, R)

    D = cfg.detections_per_image
    top_s, keep_i = batched_nms_fixed(flat_boxes, flat_scores, flat_classes,
                                      cfg.nms_thresh_test, D,
                                      fast=cfg.fast_nms)
    valid = top_s > NEG_INF / 2
    return {
        "boxes": torch.gather(flat_boxes, 1, keep_i[..., None].expand(B, D, 4)),
        "scores": torch.where(valid, top_s, torch.zeros_like(top_s)),
        "classes": torch.gather(flat_classes, 1, keep_i),
        "valid": valid,
    }
