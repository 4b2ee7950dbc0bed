"""Multilevel RoIAlign (ROIAlignV2 semantics): level assignment and the
dispatcher between the two Hopper kernels and their plain PyTorch versions.

Semantics (reference ops/roi_align.py, detectron2_config_3bands.yaml:174,
221): aligned=True half-pixel sampling, at a fixed s×s grid per bin or,
for ``sampling == 0``, adaptively at n = ceil(bin cells) samples per bin
and axis; a sample counts iff its coordinate lies in [−1, dim] and is then
clamped to the border, and each box pools from the level of the canonical
224 / level-4 rule, clipped to the levels a box of this image can reach.

Routing follows the reference's dispatcher (ops/roi_align.py:491-529):
fixed sampling on maps of at most 160² cells at P2 goes to
``roi_align_fused`` (K1); everything else, adaptive sampling at any size
and fixed sampling on large maps, to ``roi_align_fused_blocked`` (K2). The
reference sends adaptive sampling on small maps to its XLA path; K2
computes the same function. Each wrapper launches its kernel on CUDA
tensors and runs its plain version on CPU tensors. Int8 pyramid levels
(``feat_scales``) take the same routes, in the kernels' int8 mode.

Training: where the levels require a gradient, the pooling goes through
:class:`RoIAlignFunction`, whose forward is the route above and whose
backward is K5 (``roi_align_backward_kernel.py``; its plain version on CPU
tensors). Boxes carry no gradient, as in the reference, whose proposals
are ``stop_gradient`` and whose appended GT boxes are data.
"""

from __future__ import annotations

import numpy as np
import torch

from .roi_align_backward_kernel import roi_align_backward
from .roi_align_blocked_kernel import roi_align_fused_blocked, \
    roi_align_fused_blocked_ref
from .roi_align_kernel import roi_align_fused, roi_align_fused_ref

# P2 maps up to this many cells go to K1 at fixed sampling (the
# reference's _MATMUL_PATH_MAX_HW)
SMALL_MAP_HW = 160 * 160


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


def _levels(feats, boxes, canonical_size, canonical_level, min_level):
    n_lev = reachable_levels(feats, canonical_size, canonical_level,
                             min_level)
    feats = tuple(feats[:n_lev])
    lvl = level_assignment(boxes, canonical_size, canonical_level,
                           min_level, min_level + n_lev - 1)
    return feats, lvl.contiguous()


def uses_blocked(feats, sampling: int) -> bool:
    """True where the pooling goes to K2 (``roi_align_fused_blocked``):
    adaptive sampling, or a P2 map larger than ``SMALL_MAP_HW``."""
    return sampling == 0 \
        or feats[0].shape[1] * feats[0].shape[2] > SMALL_MAP_HW


def roi_align_multilevel(feats: list, boxes: torch.Tensor, out_size: int,
                         sampling: int = 2, canonical_size: int = 224,
                         canonical_level: int = 4, min_level: int = 2,
                         feat_scales=None) -> torch.Tensor:
    """feats: [P2..P5] NHWC (B, H, W, C); boxes: (B, R, 4) XYXY f32 in image
    coordinates. Returns (B, R, out_size, out_size, C) in the feature dtype
    (bf16 on the card, float32 on the CPU for int8 levels).
    ``sampling == 0`` is adaptive; ``feat_scales`` (float32, one a level or
    more) marks the levels as int8 pyramid levels.

    On CUDA tensors this launches K1 or K2 (see the module docstring); on
    CPU tensors it runs the chosen kernel's plain version."""
    if sampling < 0:
        raise ValueError(f"sampling must be >= 0, got {sampling}")
    fn = roi_align_fused_blocked if uses_blocked(feats, sampling) \
        else roi_align_fused
    feats, lvl = _levels(feats, boxes, canonical_size, canonical_level,
                         min_level)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        if feat_scales is not None:
            raise ValueError("int8 pyramid levels take no gradient")
        return RoIAlignFunction.apply(fn, boxes.detach().contiguous(), lvl,
                                      out_size, sampling, min_level, *feats)
    return fn(feats, boxes.contiguous(), lvl, out_size, sampling, min_level,
              feat_scales)


class RoIAlignFunction(torch.autograd.Function):
    """Pooling whose forward is K1 or K2 (``fn``, the route of
    :func:`roi_align_multilevel`) and whose backward is K5: the levels'
    gradients from the pooled output's, with the forward's weights. Only
    the boxes, their levels and the levels' shapes are kept for the
    backward, not the levels."""

    @staticmethod
    def forward(ctx, fn, boxes, lvl, out_size, sampling, min_level, *feats):
        ctx.save_for_backward(boxes, lvl)
        ctx.args = (out_size, sampling, min_level)
        ctx.shapes = [f.shape for f in feats]
        ctx.dtype = feats[0].dtype
        return fn(feats, boxes, lvl, out_size, sampling, min_level, None)

    @staticmethod
    def backward(ctx, grad):
        boxes, lvl = ctx.saved_tensors
        grads = roi_align_backward(grad.contiguous(), ctx.shapes, boxes, lvl,
                                   *ctx.args, dtype=ctx.dtype)
        return (None,) * 6 + tuple(grads)


def roi_align_multilevel_ref(feats: list, boxes: torch.Tensor,
                             out_size: int, sampling: int = 2,
                             canonical_size: int = 224,
                             canonical_level: int = 4, min_level: int = 2,
                             feat_scales=None) -> torch.Tensor:
    """The plain version of the same route on any device, float32 out (the
    reference's separable path)."""
    fn = roi_align_fused_blocked_ref if uses_blocked(feats, sampling) \
        else roi_align_fused_ref
    feats, lvl = _levels(feats, boxes, canonical_size, canonical_level,
                         min_level)
    return fn(feats, boxes, lvl, out_size, sampling, min_level, feat_scales)
