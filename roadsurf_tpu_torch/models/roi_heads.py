"""ROI heads: FastRCNNConvFCHead (box) + MaskRCNNConvUpsampleHead (mask).

Pinned behavior (reference detectron2_config_3bands.yaml:159-221): box head
ROIAlignV2 7x7 -> 2x FC -> per-class scores and deltas (weights 10,10,5,5);
mask head ROIAlignV2 14x14 -> 4x conv -> 2x deconv -> per-class 28x28
masks. Inference keeps score>=0.05, class-wise NMS, <=D detections per
image. All stages are fixed-shape (padded, masked).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.nms import NEG_INF, batched_nms_fixed
from ..ops.roi_align import roi_align_multilevel
from .anchors import apply_deltas, clip_boxes
from .resnet import conv


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Product in the weights' dtype, bias added in float32 (the
    reference's preferred_element_type=f32 dot)."""
    return F.linear(x.to(p["w"].dtype), p["w"]).float() + p["b"].float()


def _pool(feats, boxes, out_size, cfg):
    return roi_align_multilevel(feats, boxes, out_size,
                                sampling=cfg.pooler_sampling_ratio,
                                canonical_size=cfg.canonical_box_size,
                                canonical_level=cfg.canonical_level)


def box_head_forward(params: dict, feats: list, boxes: torch.Tensor, cfg):
    """feats: NHWC (B, H, W, C) levels; boxes (B, R, 4) ->
    (class_logits (B, R, C+1), deltas (B, R, C, 4)), float32.

    The pooled features flatten in (p, q, c) order, the row order of the
    reference's fc1 weight."""
    B, R = boxes.shape[:2]
    x = _pool(feats, boxes, cfg.box_pooler_resolution, cfg).reshape(B * R, -1)
    x = torch.relu(_linear(x, params["fc1"]))
    x = torch.relu(_linear(x, params["fc2"]))
    logits = _linear(x, params["cls"]).reshape(B, R, -1)
    deltas = _linear(x, params["bbox"]).reshape(B, R, cfg.num_classes, 4)
    return logits, deltas


def mask_head_forward(params: dict, feats: list, boxes: torch.Tensor, cfg):
    """boxes (B, D, 4) -> per-class mask logits (B, D, 2P, 2P, C), float32."""
    B, D = boxes.shape[:2]
    P = cfg.mask_pooler_resolution
    dtype = params["conv1"]["w"].dtype
    pooled = _pool(feats, boxes, P, cfg).reshape(B * D, P, P, -1)
    x = pooled.to(dtype).permute(0, 3, 1, 2)       # channels_last NCHW
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
