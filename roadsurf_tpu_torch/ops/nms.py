"""Fixed-shape non-maximum suppression.

Port of the reference's XLA designs (ops/nms.py there): everything is
padded to static shapes and invalid entries carry score ``NEG_INF``. Every
function takes boxes ``(..., N, 4)`` and scores ``(..., N)`` with any
leading batch dims (the reference vmaps its per-image form).

* :func:`nms_fixed` — exact greedy semantics: a stable descending sort,
  the greedy keep mask for every problem of the leading dims at once
  (``ops/nms_kernel.py``, the port of the reference's TPU kernel
  ``nms_keep_mask``: one kernel launch on CUDA tensors, its plain Jacobi
  form on CPU tensors), the mask scattered back to input order;
* :func:`nms_sweep` — single sweep: a box is kept iff no higher-priority
  valid box overlaps it. The fast profile uses it;
* :func:`nms_scan` — the textbook sequential form of exact greedy NMS,
  one problem, one rank a step: the semantics oracle of :func:`nms_fixed`
  and K3, as in the reference.

All keep the reference's divisionless overlap test ``inter > t·union`` and
its score-then-index priority, and :func:`top_k` breaks ties toward the
lower index as ``jax.lax.top_k`` does — so keep indices match exactly,
including the padded slots whose gathered boxes flow downstream.
"""

from __future__ import annotations

import torch

from .nms_kernel import NEG_INF, nms_keep_mask
from .nms_kernel import overlap as _overlap


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis; equal values
    come out lowest index first (a stable descending sort, sliced).
    ``torch.topk`` gives no such order, and many padded entries share
    ``NEG_INF``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _higher(scores: torch.Tensor) -> torch.Tensor:
    """(..., N, N) bool: i ranks before j under a stable descending sort —
    higher score, or equal score and lower index."""
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device)
    si = scores[..., :, None]
    sj = scores[..., None, :]
    return (si > sj) | ((si == sj) & (idx[:, None] < idx[None, :]))


def _kept_top(keep, scores, max_out):
    kept = torch.where(keep & (scores > NEG_INF / 2), scores,
                       torch.full_like(scores, NEG_INF))
    return top_k(kept, max_out)


def keep_sorted(boxes: torch.Tensor, scores: torch.Tensor,
                iou_thresh: float) -> torch.Tensor:
    """Greedy keep mask (..., N) in input order: a stable descending sort,
    :func:`~.nms_kernel.nms_keep_mask` over every problem of the leading
    dims at once (the kernel on CUDA tensors, its plain Jacobi form on CPU
    tensors), and the mask scattered back to input order."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    keep = nms_keep_mask(sboxes.contiguous(),
                         torch.gather(scores, -1, order).contiguous(),
                         iou_thresh)
    return torch.zeros_like(keep).scatter_(-1, order, keep)


def _iou_one_vs_all(b, boxes, areas, area_i):
    lt = torch.maximum(boxes[:, :2], b[:2])
    rb = torch.minimum(boxes[:, 2:], b[2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[:, 0] * wh[:, 1]
    union = areas + area_i - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_scan(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
             max_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS of one problem, boxes (N, 4) and scores (N,), as an
    N-step rank scan: the box of each rank, if still kept, removes every
    later box whose IoU with it exceeds the threshold. The semantics
    oracle of :func:`nms_fixed` (a copy of the reference's ``nms_scan``,
    with its IoU quotient: the two tests differ only where an IoU lies
    within a rounding of the threshold). Returns (keep_scores, keep_idx)
    as :func:`nms_fixed` does."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    sboxes, sscores = boxes[order], scores[order]
    areas = (sboxes[:, 2] - sboxes[:, 0]).clamp(min=0) \
        * (sboxes[:, 3] - sboxes[:, 1]).clamp(min=0)
    later = torch.arange(n, device=boxes.device)
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        row = (_iou_one_vs_all(sboxes[i], sboxes, areas, areas[i])
               > iou_thresh) & keep[i]
        keep = keep & ~(row & (later > i))
    kept = torch.where(keep & (sscores > NEG_INF / 2), sscores,
                       torch.full_like(sscores, NEG_INF))
    top_scores, top_i = top_k(kept, max_out)
    return top_scores, order[top_i]


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              max_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS. Returns (keep_scores, keep_idx) of length max_out:
    kept scores (suppressed/padded slots at NEG_INF) and their indices."""
    return _kept_top(keep_sorted(boxes, scores, iou_thresh), scores,
                     max_out)


def nms_sweep(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              max_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-sweep suppression: keeps a box iff no higher-priority valid
    box overlaps it above the threshold. Sortless: runs on the unsorted
    arrays with the score-then-index priority."""
    valid_row = (scores > NEG_INF / 2)[..., :, None]
    suppressed = (_overlap(boxes, iou_thresh) & _higher(scores)
                  & valid_row).any(dim=-2)
    return _kept_top(~suppressed, scores, max_out)


def batched_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
                      idxs: torch.Tensor, iou_thresh: float, max_out: int,
                      fast: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS: boxes with different ``idxs`` (level or class id)
    never suppress each other. Coordinate-offset trick, per image: shift
    each category's boxes to a disjoint region so one plain NMS handles
    all categories. ``fast`` selects the single-sweep variant."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.where(scores > NEG_INF / 2, boxes.amax(dim=-1),
                            zero).amax(dim=-1, keepdim=True) + 1.0
    shifted = boxes + (idxs.to(boxes.dtype) * max_coord)[..., None]
    fn = nms_sweep if fast else nms_fixed
    return fn(shifted, scores, iou_thresh, max_out)
