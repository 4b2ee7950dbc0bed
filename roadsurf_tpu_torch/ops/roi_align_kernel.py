"""Multilevel ROIAlignV2 pooling: the Hopper kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``roi_align_fused`` of the reference package
(roadsurf_tpu/ops/roi_align_pallas.py:638) in both its modes: bf16 levels,
and int8 pyramid levels with one float32 scale a level (``feat_scales``);
and float32 levels, float32 out, as the reference's XLA path pools off the
TPU (its TPU kernel casts each staged chunk to bf16,
roi_align_pallas.py:141), so that the float32 profiles run on the card.
The kernel source is ``csrc/roi_align.cu``: CUDA C++ for ``sm_90a``,
compiled by ``nvcc`` into a shared library with a plain C interface at
first use (into ``_build/``, keyed by the source's hash) and loaded with
ctypes.

Int8 levels follow the reference's XLA path, not its TPU kernel: each tap
is the dequantized bf16 value ``bf16(q · s_l)`` (roadsurf_tpu/ops/
roi_align.py:530-537), pooled in float32. The TPU kernel folds the scale
into its f32 weights instead, which moves pooled values by up to 2⁻⁹
relative; FC1 re-quantizes them, so int8 values would flip. The kernel
copies int8 cells, half the bytes of the bf16 mode, converts each staged
cell once, and writes bf16 in both modes. Float32 levels are staged as
float32 cells, twice the bytes of bf16 ones, with the same weights and
sums.

What bounds it on an H100: bytes and their latency. Each output value is
a weighted sum of s²·4 bf16 taps, 32 FLOPs at s = 2, against its own
2-byte store plus the feature cells its box touches; at the fast
profile's shapes the operations take less time on the card's f32 units
(67 TFLOP/s) than those bytes at 3.35 TB/s (``chip_smoke.py`` computes both
bounds from each run's inputs), and each box's cells come from L2 (the
boxes of an image overlap). Measured, the latency of each block's chain
of chunk copies bounds it (``csrc/roi_align.cu`` has the numbers). The kernel shares its device code with K2
(``csrc/roi_align_staged.cuh``, which sets out the design): a block per
(image, box, band of output rows) with warps over output columns and 8
channels a lane; the weights first, then only the box's rows of non-zero
weight staged in shared memory by bulk copies on mbarriers, each row's
x-pass once, and int8 cells dequantized once a staged chunk; compiled for
P = 7 and 14 at s = 2, the fast profile's poolers. The earlier design of
this kernel (a block per output row, four 4-byte tap loads a sample
straight from L2, a convert per tap in int8) took 1.8× (bf16) and 2.1×
(int8) the time of K2's kernel at these shapes, box and mask pooler summed
(``tools/time_kernels.py``, NVIDIA H100 80GB HBM3 at 700 W). The TPU
kernel's layout devices (block-diagonal x-matmul, the
t1 relayout copies, image grouping, the touch bitmap) were workarounds for
its memory hierarchy and matrix unit and have no counterpart here.

Both wrappers take what the shared kernel takes: 16-byte aligned levels, a
channel count up to 256 that is a multiple of 8 (bf16, float32) or 16 (int8
levels), out_size up to ``MAX_OUT``, and a staging ring and weight tables
that fit a block's shared memory (``check_staged_layout``, with the layout
constants read from the kernel source, ``KERNEL``), so that a layout is
refused on any device before a launch; the kernel's launcher checks the
same sum again.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from . import cuda_build

MAX_LEVELS = 4
# the layout constants of csrc/roi_align_staged.cuh (both poolers' device
# code), read from its source
KERNEL = {name: int(v) for name, v in re.findall(
    r"^constexpr int (k\w+) = (\d+);",
    (cuda_build.CSRC / "roi_align_staged.cuh").read_text(), re.M)}
MAX_SAMPLING = KERNEL["kMaxSampling"]
MAX_OUT = KERNEL["kMaxOut"]             # out_size (per-bin range tables)
MAX_C = 32 * KERNEL["kLaneC"]           # channels: 8 a lane, one warp


def _axis_weight_matrix(lo, bin_size, dim: int, stride: float,
                        out_size: int, sampling: int) -> torch.Tensor:
    """Per-box interpolation matrix along one axis, (B, R, out_size, dim):
    ``w(d) = Σ_s valid_s · max(0, 1 − |clamp(c_s) − d|) / sampling``, the
    tent form of the bilinear taps (reference ops/roi_align.py:75-103).
    ``sampling == 0`` gives the adaptive weights."""
    if sampling == 0:
        d = torch.arange(dim, dtype=torch.float32, device=lo.device)
        return _axis_weights_adaptive_at(lo, bin_size, d, dim, stride,
                                         out_size)
    p = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    d = torch.arange(dim, dtype=torch.float32, device=lo.device)
    m = torch.zeros(lo.shape + (out_size, dim), dtype=torch.float32,
                    device=lo.device)
    for s in range(sampling):
        u = (s + 0.5) / sampling
        c = (lo[..., None] + (p + u) * bin_size[..., None]) / stride - 0.5
        valid = (c >= -1.0) & (c <= float(dim))
        cc = c.clamp(0.0, float(dim) - 1.0)
        w = (1.0 - (cc[..., None] - d).abs()).clamp(min=0.0)
        m = m + torch.where(valid[..., None], w, torch.zeros_like(w))
    return m / sampling


def _axis_weights_adaptive_at(lo, bin_size, d, dim: int, stride: float,
                              out_size: int) -> torch.Tensor:
    """Exact POOLER_SAMPLING_RATIO=0 weights in closed form, uncapped, at
    the cell positions ``d`` (1-D float tensor), (B, R, out_size, len(d));
    a copy of the reference's ``_axis_weights_adaptive_at``
    (roadsurf_tpu/ops/roi_align.py:113-186) for scalar ``dim``/``stride``.

    A bin of ``bins`` cells holds n = ceil(bins) samples at spacing
    δ = bins/n, so the tent sum ``Σ_i max(0, 1 − |clamp(c_i) − d|)`` at a
    cell sums a piecewise-linear function over an arithmetic progression:
    each linear piece is a closed-form series, whatever n is. Samples in
    [−1, 0) and (dim−1, dim] collapse onto the edge cells with weight 1
    (the corrections on cells 0 and dim−1); zero-size bins (δ = 0) take
    the guarded spacing 1 with A shifted so the one sample stays put.
    ``csrc/roi_align_blocked.cu`` evaluates the same operations in the same
    order, one cell at a time; keep the two in step."""
    p = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    dim = float(dim)
    bins = bin_size[..., None] / stride                       # (B, R, 1)
    n = torch.ceil(bins).clamp(min=1.0)
    delta_t = bins / n                                        # true spacing
    delta = torch.where(delta_t > 0, delta_t, torch.ones_like(delta_t))
    # c_i = A + (i + 0.5)·delta reproduces the true samples
    A = (lo[..., None] + p * bin_size[..., None]) / stride - 0.5 \
        + 0.5 * (delta_t - delta)                             # (B, R, P)
    A = A[..., None]                                          # (B, R, P, 1)
    nn = n[..., None]                                         # (B, R, 1, 1)
    dl = delta[..., None]

    def t(x):
        # i-coordinate of position x: c_i <= x  <=>  i <= t(x)
        return (x - A) / dl - 0.5

    def series(i0, i1):
        """(count, Σ c_i) over integer i ∈ [i0, i1] ∩ [0, n−1]."""
        i0c = i0.clamp(min=0.0)
        i1c = torch.minimum(i1, nn - 1.0)
        m = (i1c - i0c + 1.0).clamp(min=0.0)
        si = 0.5 * (i0c + i1c) * m
        return m, torch.where(m > 0, m * (A + 0.5 * dl) + dl * si, 0.0)

    # window (d−1, d]: tent rises, weight c − (d−1)
    hi1 = torch.floor(t(d))
    m1, s1 = series(torch.floor(t(d - 1.0)) + 1.0, hi1)
    part1 = s1 - m1 * (d - 1.0)
    # window (d, d+1]: tent falls, weight (d+1) − c
    m2, s2 = series(hi1 + 1.0, torch.floor(t(d + 1.0)))
    part2 = m2 * (d + 1.0) - s2
    # valid samples beyond the edges weigh 1 on the edge cell
    mb0, sb0 = series(torch.ceil(t(-1.0)), torch.ceil(t(0.0)) - 1.0)
    corr0 = mb0 - (sb0 + mb0)
    mbt, sbt = series(torch.floor(t(dim - 1.0)) + 1.0, torch.floor(t(dim)))
    corrt = sbt - mbt * (dim - 1.0)
    w = part1 + part2
    w = w + torch.where(d == 0.0, corr0, 0.0)
    w = w + torch.where(d == dim - 1.0, corrt, 0.0)
    return torch.where((d >= 0.0) & (d <= dim - 1.0), w / nn, 0.0)


def bin_sizes(boxes: torch.Tensor, out_size: int):
    """(x0, y0, bin width, bin height) per box, float32. The division is by
    a tensor: on the card a division by a Python number is a product with
    its rounded reciprocal, and the kernels divide exactly."""
    boxes = boxes.float()
    k = torch.tensor(float(out_size), device=boxes.device)
    return (boxes[..., 0], boxes[..., 1],
            (boxes[..., 2] - boxes[..., 0]) / k,
            (boxes[..., 3] - boxes[..., 1]) / k)


def axis_weights(feats, boxes, lvl, out_size: int, sampling: int,
                 min_level: int):
    """Per level: (wy (B, R, P, H_l) with other-level boxes zeroed,
    wx (B, R, P, W_l)), float32; ``sampling == 0`` is adaptive."""
    x0, y0, bw, bh = bin_sizes(boxes, out_size)
    out = []
    for li, f in enumerate(feats):
        H, W = f.shape[1], f.shape[2]
        stride = float(2 ** (min_level + li))
        wy = _axis_weight_matrix(y0, bh, H, stride, out_size, sampling)
        wx = _axis_weight_matrix(x0, bw, W, stride, out_size, sampling)
        wy = wy * (lvl == li)[..., None, None].to(wy.dtype)
        out.append((wy, wx))
    return out


def dequantize(feats, feat_scales):
    """int8 levels -> their bf16 values ``bf16(q · s_l)``; other levels as
    they are when ``feat_scales`` is None."""
    if feat_scales is None:
        return feats
    return tuple((f.float() * feat_scales[i]).to(torch.bfloat16)
                 for i, f in enumerate(feats))


def roi_align_fused_ref(feats, boxes, lvl, out_size: int, sampling: int,
                        min_level: int = 2, feat_scales=None
                        ) -> torch.Tensor:
    """The plain version: separable contractions per level, levels summed,
    in float32. feats: tuple of (B, H_l, W_l, C); boxes (B, R, 4) XYXY;
    lvl (B, R) level index per box; ``feat_scales`` (≥ n_levels,) float32
    for int8 levels. Returns (B, R, P, P, C) float32."""
    feats = dequantize(feats, feat_scales)
    acc = None
    for f, (wy, wx) in zip(feats, axis_weights(feats, boxes, lvl, out_size,
                                               sampling, min_level)):
        t1 = torch.einsum("brph,bhwc->brpwc", wy, f.float())
        part = torch.einsum("brpwc,brqw->brpqc", t1, wx)
        acc = part if acc is None else acc + part
    return acc


# the C interface of csrc/roi_align.cu and csrc/roi_align_blocked.cu: level
# pointers, level sides, n_levels, min_level, scales (NULL: bf16 or float32
# levels), boxes, lvl, out, B, R, C, P, sampling, f32 (float32 levels and
# out), device, stream
POOLER_ARGTYPES = ([ctypes.c_void_p] * MAX_LEVELS
                   + [ctypes.c_int] * (2 * MAX_LEVELS + 2)
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("roi_align")
    lib.roi_align_run.argtypes = POOLER_ARGTYPES
    lib.roi_align_run.restype = ctypes.c_int
    return lib


def check_pooler_inputs(feats, boxes, lvl, feat_scales=None):
    """The checks both pooler kernels (K1 here, K2 in
    ``roi_align_blocked_kernel.py``) make of their inputs: bf16 or float32
    levels, or int8 levels with ``feat_scales``."""
    if not 1 <= len(feats) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels expected, got {len(feats)}")
    B, R = boxes.shape[:2]
    C = feats[0].shape[-1]
    dev = boxes.device
    want = (torch.bfloat16, torch.float32) if feat_scales is None \
        else (torch.int8,)
    for f in feats:
        if f.dim() != 4 or f.shape[0] != B or f.shape[-1] != C:
            raise ValueError(f"level shape {tuple(f.shape)} does not match "
                             f"(B={B}, H, W, C={C})")
        if f.dtype not in want or f.dtype != feats[0].dtype:
            raise TypeError(f"levels must be one of {want} (all alike) "
                            f"when feat_scales is "
                            f"{feat_scales is None and 'None' or 'given'}, "
                            f"got {[g.dtype for g in feats]}")
        if f.device != dev or not f.is_contiguous() \
                or f.data_ptr() % 4:
            raise ValueError("levels must be contiguous NHWC on the boxes' "
                             "device, 4-byte aligned")
    if C % 2:
        raise ValueError(f"channel count must be even, got {C}")
    if boxes.shape != (B, R, 4) or boxes.dtype != torch.float32 \
            or not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous float32 (B, R, 4)")
    if lvl.shape != (B, R) or lvl.dtype != torch.int32 \
            or lvl.device != dev or not lvl.is_contiguous():
        raise ValueError("lvl must be contiguous int32 (B, R) on the "
                         "boxes' device")
    if feat_scales is not None and (
            feat_scales.dtype != torch.float32 or feat_scales.dim() != 1
            or feat_scales.shape[0] < len(feats)
            or feat_scales.device != dev
            or not feat_scales.is_contiguous()):
        raise ValueError("feat_scales must be contiguous float32 (≥ "
                         "n_levels,) on the boxes' device")


def smem_bytes(out_size: int, side: int, int8: bool = False) -> int:
    """Shared memory a block of the pooler kernel takes (``pooler_run``
    computes the same sum): the staging ring (for int8 levels, its int8
    slots and the bf16 work buffer), the band's y-weights and all
    x-weights over the longest level side, each row's bins, and the bins'
    non-zero ranges."""
    k = KERNEL
    warps = k["kMaxWarps"]
    qpw = 1 if out_size <= warps else 2 if out_size <= 2 * warps else 4
    band = warps // qpw
    ring = (k["kStages"] + 2) * k["kStageBytes8"] if int8 \
        else k["kStages"] * k["kStageBytes"]
    return ring + 4 * (band + out_size + 1) * side + 8 * (band + out_size)


def check_staged_layout(feats, out_size: int, feat_scales=None):
    """What the shared kernel of both poolers takes beyond
    :func:`check_pooler_inputs`: a lane's 8 channels and a warp's 256,
    rows copied in 16-byte units from 16-byte aligned levels, and weight
    tables that fit a block's shared memory."""
    multiple = 8 if feat_scales is None else 16
    C = feats[0].shape[-1]
    if C % multiple or C > MAX_C:
        raise ValueError(f"channel count must be a multiple of {multiple} "
                         f"up to {MAX_C} for {feats[0].dtype} levels, got "
                         f"{C}")
    if any(f.data_ptr() % 16 for f in feats):
        raise ValueError("levels must be 16-byte aligned")
    side = max(max(f.shape[1], f.shape[2]) for f in feats)
    if smem_bytes(out_size, side, feat_scales is not None) \
            > KERNEL["kMaxSmem"]:
        raise ValueError(f"levels of side {side} at out_size={out_size} "
                         f"exceed a block's shared memory")


def launch_pooler(wrapper, name: str, entry, feats, boxes, lvl,
                  out_size: int, sampling: int, min_level: int,
                  feat_scales=None):
    """Allocate the (B, R, P, P, C) output (float32 for float32 levels,
    else bf16) and launch ``entry`` of ``csrc/<name>.cu``
    (``POOLER_ARGTYPES``) on the current stream; raise if the launch failed,
    else count it on ``wrapper`` (``launches`` for bf16 levels,
    ``launches_int8`` for int8 ones, ``launches_f32`` for float32 ones).
    Inputs checked."""
    B, R = boxes.shape[:2]
    C = feats[0].shape[-1]
    f32 = feats[0].dtype == torch.float32
    out = torch.empty((B, R, out_size, out_size, C),
                      dtype=torch.float32 if f32 else torch.bfloat16,
                      device=boxes.device)
    if out.numel() == 0:
        return out
    n = len(feats)
    ptrs = [f.data_ptr() for f in feats] + [None] * (MAX_LEVELS - n)
    dims = []
    for li in range(MAX_LEVELS):
        dims += [feats[li].shape[1], feats[li].shape[2]] if li < n else [0, 0]
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    scales = None if feat_scales is None else feat_scales.data_ptr()
    rc = entry(*ptrs, *dims, n, min_level, scales, boxes.data_ptr(),
               lvl.data_ptr(), out.data_ptr(), B, R, C, out_size, sampling,
               int(f32), boxes.device.index, stream)
    cuda_build.check(name, rc, name)
    if feat_scales is not None:
        wrapper.launches_int8 += 1
    elif f32:
        wrapper.launches_f32 += 1
    else:
        wrapper.launches += 1
    return out


def plain_on_cpu(ref, feats, boxes, lvl, out_size, sampling, min_level,
                 feat_scales):
    """A wrapper's CPU branch: the plain version in the levels' dtype
    (bf16 or float32), float32 for int8 levels."""
    out = ref(feats, boxes, lvl, out_size, sampling, min_level, feat_scales)
    return out if feat_scales is not None else out.to(feats[0].dtype)


def _check(feats, boxes, lvl, out_size, sampling, feat_scales=None):
    check_pooler_inputs(feats, boxes, lvl, feat_scales)
    if not (1 <= sampling <= MAX_SAMPLING and 1 <= out_size <= MAX_OUT):
        raise ValueError(f"unsupported out_size={out_size}, "
                         f"sampling={sampling}")
    check_staged_layout(feats, out_size, feat_scales)


def roi_align_fused(feats, boxes, lvl, out_size: int, sampling: int,
                    min_level: int = 2, feat_scales=None) -> torch.Tensor:
    """Pool (B, R, P, P, C) from NHWC levels; same arguments as
    :func:`roi_align_fused_ref`. Launches the kernel for CUDA tensors (bf16
    levels, or int8 levels with ``feat_scales``, bf16 out; float32 levels,
    float32 out) and runs the plain version for CPU tensors
    (:func:`plain_on_cpu`)."""
    if boxes.device.type == "cpu":
        return plain_on_cpu(roi_align_fused_ref, feats, boxes, lvl, out_size,
                            sampling, min_level, feat_scales)
    if boxes.device.type != "cuda":
        raise ValueError(f"no roi_align for {boxes.device.type} tensors")
    _check(feats, boxes, lvl, out_size, sampling, feat_scales)
    return launch_pooler(roi_align_fused, "roi_align",
                         _library().roi_align_run, feats, boxes, lvl,
                         out_size, sampling, min_level, feat_scales)


roi_align_fused.launches = 0
roi_align_fused.launches_int8 = 0
roi_align_fused.launches_f32 = 0
