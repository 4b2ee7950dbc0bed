"""Multilevel ROIAlignV2 pooling on large maps, with exact adaptive
sampling: the Hopper kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``roi_align_fused_blocked`` of the reference
package (roadsurf_tpu/ops/roi_align_pallas.py:471) in both its modes, bf16
levels and int8 pyramid levels with per-level scales (each tap the bf16
value ``bf16(q · s_l)``, as for K1 in ``roi_align_kernel.py``), and in both
sampling modes: the adaptive one (``sampling == 0``,
POOLER_SAMPLING_RATIO 0: n = ceil(bin cells) samples per bin, no cap) and
a fixed s×s grid. The kernel source is ``csrc/roi_align_blocked.cu``,
built and loaded by ``ops/cuda_build.py``.

What bounds it on an H100: bytes. At the 800 px parity profile the box
pooler writes 16·1000·49·256 bf16 values (401 MB) and its boxes touch up
to the whole pyramid (27 MB an image), against a few FLOPs per touched
cell and channel (``chip_smoke.py`` computes both bounds from each run's
inputs). The design: one block per (image, box); the block evaluates the
box's y-weights for all P rows and x-weights for all P columns into shared
memory, once, over the box's tap span only (a span is at most a level's
width, so a P × 200 table fits), with the same closed-form series and the
same operation order as the plain version; then threads over channel
pairs take ``Σ_y wy[p,y] · Σ_x wx[q,x] · f[y,x,c]`` straight from the NHWC
level, over each row's and column's non-zero range, so a warp reads and
writes contiguous 128-byte runs and touches each cell of the span about
once per output bin that needs it. The TPU kernel's (level, x) sort, touch
bitmap, level gates, w-block DMA, block-diagonal x-matmul and t1 relayout
were VMEM and MXU machinery and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .roi_align_kernel import MAX_SAMPLING, POOLER_ARGTYPES, \
    check_pooler_inputs, dequantize, launch_pooler, plain_on_cpu, \
    roi_align_fused_ref

MAX_OUT = 32                    # out_size (per-bin range tables)
MAX_SMEM = 232448               # bytes of shared memory a block may use


def roi_align_fused_blocked_ref(feats, boxes, lvl, out_size: int,
                                sampling: int, min_level: int = 2,
                                feat_scales=None) -> torch.Tensor:
    """The plain version: the separable contraction in float32 with the
    adaptive (``sampling == 0``) or fixed weights, levels summed, one image
    at a time as the reference's separable path does on large maps
    (roadsurf_tpu/ops/roi_align.py:320-330): the (R, P, W, C) intermediate
    is 1.4 GB an image at P2 of 800 px with R = 1000. Same arguments and
    result as :func:`roi_align_fused_ref`."""
    feats = dequantize(feats, feat_scales)
    return torch.cat([
        roi_align_fused_ref(tuple(f[b:b + 1] for f in feats),
                            boxes[b:b + 1], lvl[b:b + 1], out_size, sampling,
                            min_level)
        for b in range(boxes.shape[0])])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("roi_align_blocked")
    lib.roi_align_blocked_run.argtypes = POOLER_ARGTYPES
    lib.roi_align_blocked_run.restype = ctypes.c_int
    return lib


def _check(feats, boxes, lvl, out_size, sampling, feat_scales=None):
    check_pooler_inputs(feats, boxes, lvl, feat_scales)
    if not (0 <= sampling <= MAX_SAMPLING and 1 <= out_size <= MAX_OUT):
        raise ValueError(f"unsupported out_size={out_size}, "
                         f"sampling={sampling}")
    # the y and x weight tables (P × the longest level side, f32) and four
    # per-bin range tables
    side = max(max(f.shape[1], f.shape[2]) for f in feats)
    if 2 * out_size * side * 4 + 4 * out_size * 4 > MAX_SMEM:
        raise ValueError(f"levels of side {side} at out_size={out_size} "
                         f"exceed a block's shared memory")


def roi_align_fused_blocked(feats, boxes, lvl, out_size: int, sampling: int,
                            min_level: int = 2, feat_scales=None
                            ) -> torch.Tensor:
    """Pool (B, R, P, P, C) from NHWC levels; same arguments as
    :func:`roi_align_fused_blocked_ref`. Launches the kernel for CUDA
    tensors (bf16 levels, or int8 levels with ``feat_scales``; bf16 out)
    and runs the plain version for CPU tensors (``plain_on_cpu``)."""
    if boxes.device.type == "cpu":
        return plain_on_cpu(roi_align_fused_blocked_ref, feats, boxes, lvl,
                            out_size, sampling, min_level, feat_scales)
    if boxes.device.type != "cuda":
        raise ValueError(f"no roi_align for {boxes.device.type} tensors")
    _check(feats, boxes, lvl, out_size, sampling, feat_scales)
    return launch_pooler(roi_align_fused_blocked, "roi_align_blocked",
                         _library().roi_align_blocked_run, feats, boxes,
                         lvl, out_size, sampling, min_level, feat_scales)


roi_align_fused_blocked.launches = 0
roi_align_fused_blocked.launches_int8 = 0
