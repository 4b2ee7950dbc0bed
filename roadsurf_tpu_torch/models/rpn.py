"""Region Proposal Network (StandardRPNHead + proposal selection).

Pinned behavior (reference detectron2_config_3bands.yaml:222-251): shared
3x3 conv head over P2..P6, 3 anchors per cell, NMS 0.7, delta weights
(1,1,1,1). Everything runs at fixed shapes: per-level top-k, per-level NMS,
and the final proposal tensor is always (B, post_nms_topk, 4) with
``NEG_INF`` scores on padded slots.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.nms import NEG_INF, nms_fixed, nms_sweep, top_k
from .anchors import apply_deltas, clip_boxes
from .resnet import conv


def rpn_head_forward(params: dict, feats: list, num_anchors: int = 3):
    """Returns per-level (objectness (B, H*W*A), deltas (B, H*W*A, 4)),
    rows in (y, x, a) order like the reference's NHWC reshape."""
    logits, deltas = [], []
    for f in feats:
        t = torch.relu_(conv(f, params["conv"]))
        o = conv(t, params["objectness"])
        d = conv(t, params["deltas"])
        b = o.shape[0]
        logits.append(o.permute(0, 2, 3, 1).reshape(b, -1))
        deltas.append(d.permute(0, 2, 3, 1).reshape(b, -1, 4))
    return logits, deltas


def _local_max_gate(lg: torch.Tensor, num_anchors: int, aspect_ratios,
                    stride: int, size: float, nms_thresh: float
                    ) -> torch.Tensor:
    """Spatial local-max pre-gate for the sweep-NMS path.

    Adjacent same-aspect anchors one stride apart overlap above the NMS
    threshold when (side − stride)/(side + stride) > thresh along the
    shift axis; under single-sweep suppression an anchor with a
    higher-priority such neighbor cannot survive, so it is masked to
    NEG_INF before the pre-NMS top-k. Ties follow nms_sweep's
    score-then-flat-index priority: up/left neighbors are lower-index (win
    ties, ``>=``) and down/right higher-index (lose ties, ``>``).
    """
    B, n = lg.shape
    A = num_anchors
    hw = n // A
    side = int(round(math.sqrt(hw)))
    if side * side != hw:
        return lg          # non-square level: gate does not apply
    area = float(size) ** 2
    horiz, vert = [], []
    for a in aspect_ratios:
        w = math.sqrt(area / a)
        h = a * w
        horiz.append((w - stride) / (w + stride) > nms_thresh)
        vert.append((h - stride) / (h + stride) > nms_thresh)
    if not (any(horiz) or any(vert)):
        return lg
    x = lg.reshape(B, side, side, A)
    pad_r = torch.full_like(x[:, :1], NEG_INF)
    pad_c = torch.full_like(x[:, :, :1], NEG_INF)
    up = torch.cat([pad_r, x[:, :-1]], dim=1)
    down = torch.cat([x[:, 1:], pad_r], dim=1)
    left = torch.cat([pad_c, x[:, :, :-1]], dim=2)
    right = torch.cat([x[:, :, 1:], pad_c], dim=2)
    h_ok = torch.as_tensor(horiz, device=lg.device)        # (A,)
    v_ok = torch.as_tensor(vert, device=lg.device)
    drop = (h_ok & ((left >= x) | (right > x))) \
        | (v_ok & ((up >= x) | (down > x)))
    return torch.where(drop, torch.full_like(x, NEG_INF), x).reshape(B, n)


def select_proposals(logits: list, deltas: list, anchors: list,
                     image_size: int, pre_nms_topk: int, post_nms_topk: int,
                     nms_thresh: float, fast_nms: bool = False,
                     local_max_gate: bool = False,
                     gate_geom: list | None = None):
    """Decode + per-level top-k + per-level NMS + global top-k.

    anchors: per-level (N_l, 4) numpy arrays. Returns (boxes (B, K, 4),
    scores (B, K)) with K = post_nms_topk; padding scores are NEG_INF.

    The reference takes an approximate top-k (recall 0.95) on the large
    fine levels on its TPU; this port takes the exact top-k everywhere
    (the reference's approximate op is exact on the CPU, where the parity
    tests run).
    """
    B = logits[0].shape[0]
    dev = logits[0].device
    use_gate = local_max_gate and fast_nms and gate_geom is not None
    nms_one = nms_sweep if fast_nms else nms_fixed
    kept_boxes, kept_scores = [], []
    for l, (lg, dl, an) in enumerate(zip(logits, deltas, anchors)):
        if use_gate:
            lg = _local_max_gate(lg, *gate_geom[l], nms_thresh)
        n = lg.shape[1]
        k = min(pre_nms_topk, n)
        sc, idx = top_k(lg.float(), k)                          # (B, k)
        an_t = torch.from_numpy(np.asarray(an, np.float32)).to(dev)
        sel_anchors = an_t[idx]                                 # (B, k, 4)
        sel_deltas = torch.gather(dl.float(), 1,
                                  idx[..., None].expand(B, k, 4))
        boxes = clip_boxes(apply_deltas(sel_deltas, sel_anchors),
                           image_size, image_size)
        # drop degenerate boxes (MIN_SIZE=0 => only empty ones)
        wh_ok = (boxes[..., 2] > boxes[..., 0]) \
            & (boxes[..., 3] > boxes[..., 1])
        sc = torch.where(wh_ok, sc, torch.full_like(sc, NEG_INF))
        # boxes on different levels never suppress each other, so
        # level-aware NMS is exactly per-level NMS + a global top-k over
        # each level's top-`post_nms_topk` survivors
        k_out = min(post_nms_topk, k)
        top_s, keep_i = nms_one(boxes, sc, nms_thresh, k_out)
        kept_boxes.append(torch.gather(boxes, 1,
                                       keep_i[..., None].expand(B, k_out, 4)))
        kept_scores.append(top_s)
    boxes = torch.cat(kept_boxes, dim=1)
    scores = torch.cat(kept_scores, dim=1)
    pscores, top_i = top_k(scores, post_nms_topk)
    pboxes = torch.gather(boxes, 1,
                          top_i[..., None].expand(B, post_nms_topk, 4))
    return pboxes, pscores
