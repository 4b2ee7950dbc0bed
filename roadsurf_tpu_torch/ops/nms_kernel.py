"""Greedy NMS keep mask over score-sorted boxes: the Hopper kernel's wrapper,
its plain PyTorch version, and plain mirrors of the kernel's two phases.

Replaces the TPU kernel ``nms_keep_mask`` of the reference package
(roadsurf_tpu/ops/nms_pallas.py:59, ``_nms_kernel`` :30). The kernel source
is ``csrc/nms.cu``, built and loaded by ``ops/cuda_build.py``. It keeps the
port's divisionless overlap test ``inter > t·union`` (the reference's XLA
``nms_fixed``, which its parity forward runs), not the TPU kernel's
``inter/union > t``.

What bounds it on an H100: neither bytes nor operations but the greedy
scan's chain of dependent steps. A problem of N boxes reads 20·N bytes and
tests at most N²/2 pairs (~12 f32 operations each), microseconds of card
time, but rank i can be decided only after every kept rank before it. The
design takes the pair tests off that chain and keeps the chain in
registers: a pair phase tests every pair of a problem at once into 64-bit
suppression words (:func:`suppression_words` is its plain mirror), then a
sweep phase, one warp per problem, settles the ranks 64 at a time from
those words, each block of 64 rows staged in shared memory ahead of it,
with no block barrier (:func:`sweep_words`). The words live in
``torch.empty`` scratch of ``problems · N · row_words(N)`` uint64 (10 MB
for the parity RPN's 80 problems of 1000, 8 MB for its 16 class problems
of 2000); a lane of the sweep holds 4 words of the removed mask, so
N ≤ 8192 (and three staged blocks of 64 rows of 128 words still fit a
block's shared memory).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

NEG_INF = -1e10
WORD = 64                       # ranks a suppression word covers
MAX_N = 32 * 4 * WORD           # the sweep's words: 4 a lane, 32 lanes
MAX_PROBLEMS = 65535            # the pair phase's grid.y


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


def row_words(n: int) -> int:
    """Words a row of the suppression matrix holds: ceil(n/64), rounded up
    to even so that every row starts on 16 bytes (the sweep copies rows
    with bulk copies)."""
    nw = -(-n // WORD)
    return nw + nw % 2


def suppression_words(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thresh: float) -> torch.Tensor:
    """The kernel's pair phase, plain: (..., N, row_words(N)) int64 holding
    uint64 words, bit k of word w of row i set iff j = 64·w + k > i, both
    are valid and ``overlap(i, j)``. Rows' words below their own tile, and
    a padding word, are 0 (the kernel leaves them unwritten and never reads
    them)."""
    n = scores.shape[-1]
    nw = row_words(n)
    valid = scores > NEG_INF / 2
    later = torch.ones((n, n), dtype=torch.bool,
                       device=scores.device).triu(1)
    s = overlap(boxes, iou_thresh) & later & valid[..., :, None] \
        & valid[..., None, :]
    s = torch.nn.functional.pad(s, (0, nw * WORD - n))
    bits = s.reshape(s.shape[:-1] + (nw, WORD)).long() \
        << torch.arange(WORD, device=s.device)
    # disjoint bits: the sum is the OR (bit 63 wraps to the sign)
    return bits.sum(-1)


def sweep_words(words: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """The kernel's sweep phase, plain: the keep mask (..., N) bool from
    :func:`suppression_words`. Blocks of 64 ranks in order: each rank of a
    block is kept iff valid and not yet removed, and a kept rank's
    diagonal word removes later ranks of the block; then the kept ranks'
    rows are OR-ed into the later words."""
    n = scores.shape[-1]
    nw = words.shape[-1]
    w = words.reshape(-1, n, nw)
    valid = (scores > NEG_INF / 2).reshape(-1, n)
    removed = torch.zeros((w.shape[0], nw), dtype=torch.int64,
                          device=w.device)
    keep = torch.zeros_like(valid)
    for b in range(nw):
        r = removed[:, b]
        for k in range(min(WORD, n - WORD * b)):
            i = WORD * b + k
            alive = valid[:, i] & ((r >> k) & 1 == 0)
            r = torch.where(alive, r | w[:, i, b], r)
            keep[:, i] = alive
        rows = slice(WORD * b, min(n, WORD * (b + 1)))
        for i in range(rows.start, rows.stop):
            removed[:, b + 1:] |= torch.where(keep[:, i, None],
                                              w[:, i, b + 1:], 0)
    return keep.reshape(scores.shape)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("nms")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nms_pair_words_f32.argtypes = [vp, vp, vp, i, i, ctypes.c_float, i,
                                       vp]
    lib.nms_pair_words_f32.restype = i
    lib.nms_sweep_words.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.nms_sweep_words.restype = i
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
                         f"{MAX_N} fit the sweep's registers")
    n = scores.shape[-1]
    if n and scores.numel() // n > MAX_PROBLEMS:
        raise ValueError(f"{scores.numel() // n} problems; at most "
                         f"{MAX_PROBLEMS} a launch")


def _cuda_args(scores):
    N = scores.shape[-1]
    return (scores.numel() // N, N, scores.device.index,
            torch.cuda.current_stream(scores.device).cuda_stream)


def pair_phase(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
               words: torch.Tensor) -> torch.Tensor:
    """Launch the pair phase on CUDA tensors (checked), writing ``words``
    ((..., N, row_words(N)) int64, its rows' words from their own tile on);
    not counted. :func:`nms_keep_mask` runs it, and ``chip_smoke.py``
    holds it against :func:`suppression_words`."""
    problems, N, dev, stream = _cuda_args(scores)
    if words.shape != scores.shape + (row_words(N),) \
            or words.dtype != torch.int64 or not words.is_contiguous() \
            or words.device != scores.device:
        raise ValueError("words must be contiguous int64 (..., N, "
                         "row_words(N)) on the scores' device")
    rc = _library().nms_pair_words_f32(
        boxes.data_ptr(), scores.data_ptr(), words.data_ptr(), problems, N,
        float(iou_thresh), dev, stream)
    cuda_build.check("nms", rc, "nms pair phase")
    return words


def sweep_phase(words: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Launch the sweep phase on the pair phase's ``words``; the keep mask
    (..., N) bool. Not counted."""
    problems, N, dev, stream = _cuda_args(scores)
    keep = torch.empty(scores.shape, dtype=torch.uint8, device=scores.device)
    rc = _library().nms_sweep_words(scores.data_ptr(), words.data_ptr(),
                                    keep.data_ptr(), problems, N, dev, stream)
    cuda_build.check("nms", rc, "nms sweep phase")
    return keep.view(torch.bool)


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_thresh: float) -> torch.Tensor:
    """Greedy keep mask (..., N) bool of score-sorted boxes (..., N, 4);
    same arguments as :func:`nms_keep_mask_ref`. For CUDA tensors it
    launches the pair and the sweep phase over every problem of the
    leading dims (one count on ``launches``); for CPU tensors it runs the
    plain version."""
    if scores.device.type == "cpu":
        return nms_keep_mask_ref(boxes, scores, iou_thresh)
    if scores.device.type != "cuda":
        raise ValueError(f"no nms for {scores.device.type} tensors")
    _check(boxes, scores)
    N = scores.shape[-1]
    if scores.numel() == 0:
        return torch.empty(scores.shape, dtype=torch.bool,
                           device=scores.device)
    words = torch.empty(scores.shape + (row_words(N),), dtype=torch.int64,
                        device=scores.device)
    keep = sweep_phase(pair_phase(boxes, scores, iou_thresh, words), scores)
    nms_keep_mask.launches += 1
    return keep


nms_keep_mask.launches = 0
