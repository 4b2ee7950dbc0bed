"""Fixed-shape non-maximum suppression, plain PyTorch.

Port of the reference's XLA designs (ops/nms.py there): everything is
padded to static shapes and invalid entries carry score ``NEG_INF``. Every
function takes boxes ``(..., N, 4)`` and scores ``(..., N)`` with any
leading batch dims (the reference vmaps its per-image form).

* :func:`nms_fixed` — exact greedy semantics as the Jacobi fixpoint of the
  score-rank recursion (identical keep set to the sequential scan);
* :func:`nms_sweep` — single sweep: a box is kept iff no higher-priority
  valid box overlaps it. The fast profile uses it.

Both keep the reference's divisionless overlap test ``inter > t·union`` and
its score-then-index priority, and :func:`top_k` breaks ties toward the
lower index as ``jax.lax.top_k`` does — so keep indices match exactly,
including the padded slots whose gathered boxes flow downstream.
"""

from __future__ import annotations

import torch

NEG_INF = -1e10


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis; equal values
    come out lowest index first (a stable descending sort, sliced).
    ``torch.topk`` gives no such order, and many padded entries share
    ``NEG_INF``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _overlap(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """(..., N, N) bool: iou(i, j) > t, tested as inter > t·union (union ≥
    0, and union = 0 ⇒ inter = 0)."""
    areas = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) \
        * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = areas[..., :, None] + areas[..., None, :] - inter
    return inter > iou_thresh * union


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


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              max_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS. Returns (keep_scores, keep_idx) of length max_out:
    kept scores (suppressed/padded slots at NEG_INF) and their indices.

    The greedy keep set is the unique fixpoint of
        keep[i] = ¬∃j: rank(j) < rank(i) ∧ keep[j] ∧ iou(i, j) > t;
    Jacobi-iterating it from keep=all converges in suppression-chain-depth
    sweeps. Each sweep reads the result back to test convergence (one
    host sync per sweep): the fast profile never calls this form.
    """
    # M[i, j]: j (if kept) suppresses i
    M = _overlap(boxes, iou_thresh) \
        & _higher(scores).transpose(-1, -2) \
        & (scores > NEG_INF / 2)[..., None, :]
    keep = torch.ones_like(scores, dtype=torch.bool)
    while True:
        new = ~(M & keep[..., None, :]).any(dim=-1)
        if torch.equal(new, keep):
            break
        keep = new
    return _kept_top(keep, scores, max_out)


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
