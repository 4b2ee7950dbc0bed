"""The gradient of multilevel ROIAlignV2 with respect to the levels: the
Hopper kernel's wrapper (K5) and its plain PyTorch version.

The reference package has no TPU kernel for this gradient: it trains with
its XLA separable pooler and takes the gradient from XLA's autodiff
(roadsurf_tpu/ops/roi_align.py:318 ``_roi_align_separable``), because its
fused kernels have no VJP. The port's training forward pools with K1 and
K2 (``ops/roi_align.py`` routes a pooling whose levels require a gradient
through an ``autograd.Function``), so its backward is this kernel:
``csrc/roi_align_backward.cu``, CUDA C++ for ``sm_90a`` built by
``ops/cuda_build.py``. For box r on level l with the forward's axis weights
``wy`` (P, H_l) and ``wx`` (P, W_l) it adds ``wyᵀ · dP[b, r] · wx``, per
channel, into the level's gradient, in both sampling modes (a fixed s×s
grid, and the adaptive n = ceil(bin cells)); the weights come from the
forward's device code (``csrc/roi_align_staged.cuh``), bit for bit.

Its bound on an H100 is bytes, d pooled read once and the levels'
gradients written once (``chip_smoke.py`` computes it); in practice the
weights' evaluations and the sums' latency set its time. The design
is output-stationary (the source's note has the details): a block owns a
tile of ``TILE_H`` rows, ``tile_w(P)`` columns and ``chunk_c(P)``
channels of one level of one image, culls the image's boxes to those
whose region overlaps the tile; two producer warps take each kept box's
d pooled slice through TMA and evaluate its weights over the tile only,
eight consumer warps sum the boxes' contributions in f32 registers in
ascending box order, and the block writes the tile once, in bf16 or
float32. d pooled comes in bf16 (the bf16 and int8 profiles' training) or
in float32 (the float32 profiles', whose forward runs K1 and K2 in their
float32 mode; then the gradients are float32 too). No memset, no
accumulator, no atomics: the result is bitwise the
same from run to run. The tile's sizes are read from the source
(``KERNEL``), so that the CPU tests' mirror of the kernel's tiles and sums
uses the kernel's own.

On CPU tensors :func:`roi_align_backward` runs the plain version, the
explicit transposed contractions of the forward's plain version
(``roi_align_fused_ref``): per level, ``t = dP · wx`` then ``wyᵀ · t``.
On CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from . import cuda_build
from .roi_align_kernel import MAX_C, MAX_LEVELS, MAX_OUT, MAX_SAMPLING, \
    axis_weights

# the tile and ring constants of csrc/roi_align_backward.cu, read from its
# source
KERNEL = {name: int(v) for name, v in re.findall(
    r"^constexpr int (k\w+) = (\d+);",
    (cuda_build.CSRC / "roi_align_backward.cu").read_text(), re.M)}
TILE_H = KERNEL["kTileH"]        # rows of a block's output tile


def chunk_c(out_size: int) -> int:
    """Channels of a block's output tile: all 256 where a box's slice of
    them fits a ring slot (P <= 8), else 64."""
    return KERNEL["kWideC"] if out_size <= KERNEL["kWideMaxP"] \
        else KERNEL["kNarrowC"]


def tile_w(out_size: int) -> int:
    """Columns of a block's output tile: its consumer threads over
    ``chunk_c / 8`` threads a column."""
    return 32 * KERNEL["kConsumerWarps"] // (chunk_c(out_size) // 8)


def _meta_levels(shapes):
    """Shape-only stand-ins for the levels (``axis_weights`` reads their
    sides)."""
    return tuple(torch.empty(s, device="meta") for s in shapes)


def roi_align_backward_ref(dout, shapes, boxes, lvl, out_size: int,
                           sampling: int, min_level: int = 2) -> list:
    """The plain version: d levels from d pooled ``dout`` (B, R, P, P, C)
    for levels of ``shapes`` [(B, H_l, W_l, C), ...], one image at a time
    (the (R, P, W, C) intermediate is ~1.5 GB an image at P2 of 800 px and
    R = 1016). Returns float32 (B, H_l, W_l, C) tensors."""
    grads = [torch.zeros(s, dtype=torch.float32, device=dout.device)
             for s in shapes]
    metas = _meta_levels(shapes)
    for b in range(boxes.shape[0]):
        g = dout[b].float()                                  # (R, P, P, C)
        ws = axis_weights(tuple(m[b:b + 1] for m in metas), boxes[b:b + 1],
                          lvl[b:b + 1], out_size, sampling, min_level)
        for l, (wy, wx) in enumerate(ws):
            t = torch.einsum("rpqc,rqw->rpwc", g, wx[0])
            grads[l][b] = torch.einsum("rph,rpwc->hwc", wy[0], t)
    return grads


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("roi_align_backward")
    lib.roi_align_backward_run.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * (2 * MAX_LEVELS + 4)
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.roi_align_backward_run.restype = ctypes.c_int
    return lib


def part_bins(out_size: int, esize: int = 2) -> int:
    """Bin rows p of a box's d pooled slice that one tensor copy holds:
    whole bin rows of at most TMA's 256-row box side and of a ring slot's
    bytes, for d pooled values of ``esize`` bytes (2: bf16, 4: float32)."""
    k = KERNEL
    rows = min(k["kMaxCopyRows"], k["kMaxSlotBytes"] // (chunk_c(out_size)
                                                         * esize))
    return max(1, min(out_size, rows // out_size))


def smem_bytes(out_size: int, esize: int = 2) -> int:
    """Shared memory a block takes (``roi_align_backward_run`` computes the
    same sum): the 128-byte alignment; per ring slot the d pooled slice,
    its two barriers and its weight tables over the tile (each bin's rows
    and columns, each bin's range of rows, the rows' range of bins, each
    column's range of bins); the culled box list and the warps' counts. It
    does not depend on the levels' sides."""
    k, P = KERNEL, out_size
    slot = part_bins(P, esize) * P * chunk_c(P) * esize
    tw = tile_w(P)
    table = (P * (TILE_H + tw + 2) + 2 + 2 * tw + 3) // 4 * 4
    threads = k["kBwdThreads"]
    counts = -(-k["kMaxList"] // threads) * (threads // 32)
    return (128 + k["kRing"] * (slot + 16 + 4 * table)
            + 4 * (k["kMaxList"] + counts))


def _check(dout, shapes, boxes, lvl, out_size, sampling, dtype):
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels expected, got "
                         f"{len(shapes)}")
    B, R = boxes.shape[:2]
    C = shapes[0][-1]
    for s in shapes:
        if len(s) != 4 or s[0] != B or s[-1] != C:
            raise ValueError(f"level shape {tuple(s)} does not match "
                             f"(B={B}, H, W, C={C})")
    if C % 8 or C > MAX_C:
        raise ValueError(f"channel count must be a multiple of 8 up to "
                         f"{MAX_C}, got {C}")
    if not (0 <= sampling <= MAX_SAMPLING and 1 <= out_size <= MAX_OUT):
        raise ValueError(f"unsupported out_size={out_size}, "
                         f"sampling={sampling}")
    dev = boxes.device
    if dout.shape != (B, R, out_size, out_size, C) \
            or dout.dtype not in (torch.bfloat16, torch.float32) \
            or dout.device != dev or not dout.is_contiguous() \
            or dout.data_ptr() % 16:
        raise ValueError("dout must be contiguous bf16 or float32 (B, R, P,"
                         " P, C) on the boxes' device, 16-byte aligned")
    if dout.dtype == torch.float32 and dtype != torch.float32:
        raise ValueError("a float32 dout gives float32 level gradients, "
                         f"not {dtype}")
    if boxes.shape != (B, R, 4) or boxes.dtype != torch.float32 \
            or not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous float32 (B, R, 4)")
    if lvl.shape != (B, R) or lvl.dtype != torch.int32 \
            or lvl.device != dev or not lvl.is_contiguous():
        raise ValueError("lvl must be contiguous int32 (B, R) on the boxes' "
                         "device")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"level gradients in bf16 or float32, not {dtype}")
    if B * R * out_size * out_size >= 2 ** 31:
        raise ValueError("B·R·P·P rows of dout must stay below 2^31 (the "
                         "tensor copies' row coordinate)")


def roi_align_backward(dout, shapes, boxes, lvl, out_size: int,
                       sampling: int, min_level: int = 2,
                       dtype=torch.bfloat16) -> list:
    """d levels in ``dtype`` ((B, H_l, W_l, C) each, for levels of
    ``shapes``) from d pooled ``dout`` (B, R, P, P, C); boxes (B, R, 4)
    f32 XYXY, lvl (B, R) int32. Launches the kernel for CUDA tensors (a
    bf16 ``dout``, gradients in ``dtype``, bf16 or float32; or a float32
    ``dout`` and float32 gradients) and runs the plain version for CPU
    tensors."""
    shapes = [tuple(int(d) for d in s) for s in shapes]
    if boxes.device.type == "cpu":
        return [g.to(dtype) for g in roi_align_backward_ref(
            dout, shapes, boxes, lvl, out_size, sampling, min_level)]
    if boxes.device.type != "cuda":
        raise ValueError(f"no roi_align backward for {boxes.device.type} "
                         f"tensors")
    _check(dout, shapes, boxes, lvl, out_size, sampling, dtype)
    sizes = [s[0] * s[1] * s[2] * s[3] for s in shapes]
    dev = boxes.device
    out = torch.empty(sum(sizes), dtype=dtype, device=dev)
    B, R = boxes.shape[:2]
    dims = []
    for li in range(MAX_LEVELS):
        dims += list(shapes[li][1:3]) if li < len(shapes) else [0, 0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32_in = dout.dtype == torch.float32
    rc = _library().roi_align_backward_run(
        out.data_ptr(), int(dtype == torch.float32), int(f32_in), *dims,
        len(shapes),
        min_level, boxes.data_ptr(), lvl.data_ptr(), dout.data_ptr(), B, R,
        shapes[0][-1], out_size, sampling, dev.index, stream)
    cuda_build.check("roi_align_backward", rc, "roi_align_backward")
    if f32_in:
        roi_align_backward.launches_f32 += 1
    else:
        roi_align_backward.launches += 1
    return [part.view(s) for part, s in zip(out.split(sizes), shapes)]


roi_align_backward.launches = 0
roi_align_backward.launches_f32 = 0
