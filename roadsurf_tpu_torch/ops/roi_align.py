"""Multilevel RoIAlign (ROIAlignV2 semantics): level assignment and the
dispatcher between the Hopper kernel and its plain PyTorch version.

Semantics (reference ops/roi_align.py, detectron2_config_3bands.yaml:174,
221): aligned=True half-pixel sampling at a fixed s×s grid per bin, a
sample counts iff its coordinate lies in [−1, dim] and is then clamped to
the border, and each box pools from the level of the canonical 224 /
level-4 rule, clipped to the levels a box of this image can reach.
"""

from __future__ import annotations

import numpy as np
import torch

from .roi_align_kernel import roi_align_fused, roi_align_fused_ref

ADAPTIVE_SAMPLING_ITEM = (
    "ROADMAP.md Queue B: roi_align_fused_blocked (K2, adaptive "
    "POOLER_SAMPLING_RATIO 0 with the 800 px parity profile)")


def level_assignment(boxes: torch.Tensor, canonical_size: int,
                     canonical_level: int, min_level: int,
                     max_level: int) -> torch.Tensor:
    """(B, R) int32 level index (0 = ``min_level``) per box."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    area = w * h
    lvl = torch.floor(canonical_level
                      + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32) - min_level


def reachable_levels(feats: list, canonical_size: int = 224,
                     canonical_level: int = 4, min_level: int = 2) -> int:
    """Number of FPN levels a box can be assigned to. Boxes are clipped to
    the image, so sqrt(area) <= sqrt(H*W) bounds the level: at 256px only
    P2..P4 are reachable. ``feats`` are NHWC (B, H, W, C)."""
    S = float(np.sqrt(float(feats[0].shape[1]) * float(feats[0].shape[2]))) \
        * 2 ** min_level
    top = int(np.floor(canonical_level
                       + np.log2(max(S, 1) / canonical_size + 1e-8)))
    return min(len(feats), max(1, top - min_level + 1))


def _levels(feats, boxes, sampling, canonical_size, canonical_level,
            min_level):
    if sampling <= 0:
        # checked before any device branch: the adaptive pooler is never
        # stood in for by the fixed-sampling kernel or the plain version
        raise NotImplementedError(
            f"adaptive pooler sampling (sampling={sampling}) is not ported;"
            f" see {ADAPTIVE_SAMPLING_ITEM}")
    n_lev = reachable_levels(feats, canonical_size, canonical_level,
                             min_level)
    feats = tuple(feats[:n_lev])
    lvl = level_assignment(boxes, canonical_size, canonical_level,
                           min_level, min_level + n_lev - 1)
    return feats, lvl.contiguous()


def roi_align_multilevel(feats: list, boxes: torch.Tensor, out_size: int,
                         sampling: int = 2, canonical_size: int = 224,
                         canonical_level: int = 4,
                         min_level: int = 2) -> torch.Tensor:
    """feats: [P2..P5] NHWC (B, H, W, C); boxes: (B, R, 4) XYXY f32 in image
    coordinates. Returns (B, R, out_size, out_size, C) in the feature dtype.

    On CUDA tensors this launches the Hopper kernel
    (ops/roi_align_kernel.py); on CPU tensors it runs the kernel's plain
    version. ``sampling == 0`` raises on every device."""
    feats, lvl = _levels(feats, boxes, sampling, canonical_size,
                         canonical_level, min_level)
    return roi_align_fused(feats, boxes.contiguous(), lvl, out_size,
                           sampling, min_level)


def roi_align_multilevel_ref(feats: list, boxes: torch.Tensor,
                             out_size: int, sampling: int = 2,
                             canonical_size: int = 224,
                             canonical_level: int = 4,
                             min_level: int = 2) -> torch.Tensor:
    """The plain version on any device, float32 out (the reference's
    separable path)."""
    feats, lvl = _levels(feats, boxes, sampling, canonical_size,
                         canonical_level, min_level)
    return roi_align_fused_ref(feats, boxes, lvl, out_size, sampling,
                               min_level)
