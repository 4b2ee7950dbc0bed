"""Multilevel ROIAlignV2 pooling on large maps, with exact adaptive
sampling: the Hopper kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``roi_align_fused_blocked`` of the reference
package (roadsurf_tpu/ops/roi_align_pallas.py:471) in both its modes, bf16
levels and int8 pyramid levels with per-level scales (each tap the bf16
value ``bf16(q · s_l)``, as for K1 in ``roi_align_kernel.py``), and in
float32 (float32 levels and out, the reference's XLA path off the TPU, as
for K1), and in both
sampling modes: the adaptive one (``sampling == 0``,
POOLER_SAMPLING_RATIO 0: n = ceil(bin cells) samples per bin, no cap) and
a fixed s×s grid. The kernel source is ``csrc/roi_align_blocked.cu``,
built and loaded by ``ops/cuda_build.py``.

What bounds it on an H100: bytes and their latency, then instruction
issue. At the 800 px parity profile the box pooler writes 16·1000·49·256
bf16 values (401 MB), and each box reads every cell of its region once
(from L2: an image's 1000 proposals overlap), against one multiply-add per
cell and channel, some 300× below the card's ridge (``chip_smoke.py``
computes the byte bound from each run's inputs, and beside it
``box_bytes``, the sum over boxes of their touched cells). The design (the
note in ``csrc/roi_align_blocked.cu`` has the details): a block per
(image, box, band of output rows), warps over output columns, 8 channels a
lane with the band's bins in registers, so the mask pooler's 1,600 boxes
make 6,400 blocks; the weights first (same closed-form series and
operation order as the plain version), then only the rows and columns of
non-zero weight staged through a ring of shared-memory buffers by bulk
copies (one per row segment, completion on an mbarrier) while the
previous chunk is summed; the x-pass once per staged row. Int8 chunks
are copied as int8 and each of their cells dequantized once, 16 channels
a thread, into a bf16 work buffer that the x-pass reads. The TPU kernel's
(level, x) sort, touch bitmap, level gates, w-block DMA, block-diagonal
x-matmul and t1 relayout were VMEM and MXU machinery and have no
counterpart here.

The device code is in ``csrc/roi_align_staged.cuh``, which K1's source
includes too; ``roi_align_blocked.cu`` is K2's entry point (every sampling
mode, P and level side at run time). The kernel takes 16-byte aligned
levels and a channel count up to 256 that is a multiple of 8 (bf16) or 16
(int8 levels); the wrapper checks both, and that the staging ring and the
weight tables (P + band + 1 rows of the longest level side) fit a block's
shared memory (``check_staged_layout``, shared with K1's wrapper, with the
layout constants read from the kernel source, ``KERNEL``), so that a
layout is refused on any device before a launch; the kernel's launcher
checks the same sum again.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .roi_align_kernel import KERNEL, MAX_C, MAX_OUT, MAX_SAMPLING, \
    POOLER_ARGTYPES, check_pooler_inputs, check_staged_layout, dequantize, \
    launch_pooler, plain_on_cpu, roi_align_fused_ref, smem_bytes

__all__ = ["KERNEL", "MAX_C", "MAX_OUT", "MAX_SAMPLING", "smem_bytes",
           "roi_align_fused_blocked", "roi_align_fused_blocked_ref"]


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
    check_staged_layout(feats, out_size, feat_scales)


def roi_align_fused_blocked(feats, boxes, lvl, out_size: int, sampling: int,
                            min_level: int = 2, feat_scales=None
                            ) -> torch.Tensor:
    """Pool (B, R, P, P, C) from NHWC levels; same arguments as
    :func:`roi_align_fused_blocked_ref`. Launches the kernel for CUDA
    tensors (bf16 levels, or int8 levels with ``feat_scales``, bf16 out;
    float32 levels, float32 out) and runs the plain version for CPU tensors
    (``plain_on_cpu``)."""
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
roi_align_fused_blocked.launches_f32 = 0
