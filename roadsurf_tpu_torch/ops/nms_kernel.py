"""Greedy NMS keep mask over score-sorted boxes: the Hopper kernel's wrapper
and its plain PyTorch version.

Replaces the TPU kernel ``nms_keep_mask`` of the reference package
(roadsurf_tpu/ops/nms_pallas.py:59, ``_nms_kernel`` :30). The kernel source
is ``csrc/nms.cu``, built and loaded by ``ops/cuda_build.py``. It keeps the
port's divisionless overlap test ``inter > t·union`` (the reference's XLA
``nms_fixed``, which its parity forward runs), not the TPU kernel's
``inter/union > t``.

What bounds it on an H100: neither bytes nor operations but the greedy
scan's chain of dependent steps. A problem of N boxes reads 20·N bytes and
tests at most N²/2 pairs (~12 f32 operations each), microseconds of card
time, but rank i can be decided only after every kept rank before it.
The design keeps that chain on the card and cheap: one block per problem
(an image, or an (image, level) pair), its boxes, areas and keep flags in
shared memory, a loop over rank with the threads over the later boxes and
one barrier per kept rank, and no host round trip (the plain version's
Jacobi sweeps each read a flag back). A suppressed rank costs one shared
load. The problems run side by side on the SMs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

NEG_INF = -1e10
MAX_N = 232448 // 21            # boxes whose tables fit a block's memory


def overlap(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
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


def nms_keep_mask_ref(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thresh: float) -> torch.Tensor:
    """The plain version. boxes (..., N, 4) and scores (..., N), sorted by
    score, descending and stable; returns the greedy keep mask (..., N)
    bool: i is kept iff it is valid (score > NEG_INF/2) and no kept valid
    box before it overlaps it. That keep set is the unique fixpoint of
        keep[i] = ¬∃j < i: keep[j] ∧ valid[j] ∧ overlap(i, j);
    Jacobi-iterating it from keep = all converges in one sweep per link of
    the longest suppression chain, each sweep reading a flag back (one
    host sync per sweep)."""
    n = scores.shape[-1]
    valid = scores > NEG_INF / 2
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=scores.device).tril(-1)
    # M[i, j]: j (if kept) suppresses i
    M = overlap(boxes, iou_thresh) & earlier & valid[..., None, :]
    keep = torch.ones_like(valid)
    while True:
        new = ~(M & keep[..., None, :]).any(dim=-1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep & valid


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("nms")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nms_keep_mask_f32.argtypes = [vp, vp, vp, i, i, ctypes.c_float, i,
                                      vp]
    lib.nms_keep_mask_f32.restype = i
    return lib


def _check(boxes, scores):
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got "
                        f"{boxes.dtype} and {scores.dtype}")
    if boxes.shape != scores.shape + (4,) or scores.dim() < 1:
        raise ValueError(f"boxes {tuple(boxes.shape)} and scores "
                         f"{tuple(scores.shape)} are not (..., N, 4) and "
                         f"(..., N)")
    if boxes.device != scores.device or not boxes.is_contiguous() \
            or not scores.is_contiguous():
        raise ValueError("boxes and scores must be contiguous, on one device")
    if scores.shape[-1] > MAX_N:
        raise ValueError(f"{scores.shape[-1]} boxes a problem; at most "
                         f"{MAX_N} fit a block")


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_thresh: float) -> torch.Tensor:
    """Greedy keep mask (..., N) bool of score-sorted boxes (..., N, 4);
    same arguments as :func:`nms_keep_mask_ref`. Launches the kernel for
    CUDA tensors (one block per problem of the leading dims) and runs the
    plain version for CPU tensors."""
    if scores.device.type == "cpu":
        return nms_keep_mask_ref(boxes, scores, iou_thresh)
    if scores.device.type != "cuda":
        raise ValueError(f"no nms for {scores.device.type} tensors")
    _check(boxes, scores)
    N = scores.shape[-1]
    problems = scores.numel() // N if N else 0
    keep = torch.empty(scores.shape, dtype=torch.uint8, device=scores.device)
    if keep.numel() == 0:
        return keep.bool()
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = _library().nms_keep_mask_f32(
        boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), problems, N,
        float(iou_thresh), scores.device.index, stream)
    cuda_build.check("nms", rc, "nms")
    nms_keep_mask.launches += 1
    return keep.view(torch.bool)


nms_keep_mask.launches = 0
