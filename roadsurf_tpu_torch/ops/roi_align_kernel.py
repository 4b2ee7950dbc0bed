"""Multilevel ROIAlignV2 pooling: the Hopper kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``roi_align_fused`` of the reference package
(roadsurf_tpu/ops/roi_align_pallas.py:638) in its bf16 mode. The kernel
source is ``csrc/roi_align.cu``: CUDA C++ for ``sm_90a``, compiled by
``nvcc`` into a shared library with a plain C interface at first use
(into ``_build/``, keyed by the source's hash) and loaded with ctypes.

What bounds it on an H100: bytes. Each output value is a weighted sum of
s²·4 bf16 taps, 32 FLOPs at s = 2, against its own 2-byte store plus the
feature cells its box touches; at the fast profile's shapes the operations
take less time on the card's f32 units (67 TFLOP/s) than those bytes at
3.35 TB/s (``chip_smoke.py`` computes both bounds from each run's inputs).
The design does only what that bound asks of a first kernel: one block per
(image, box, output row), threads over channels two bf16 at a time, so a
warp's tap loads and its output stores are contiguous 128-byte runs of the
NHWC rows, and the blocks of one box re-read the same rows from L2, not
from device memory. The tap coordinates and weights are computed once per
block into shared memory; no output is re-read and nothing else is
written. The TPU kernel's layout devices (block-diagonal x-matmul, the t1
relayout copies, image grouping, the touch bitmap) were workarounds for
its memory hierarchy and matrix unit and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "roi_align.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
MAX_LEVELS = 4
MAX_SAMPLING = 16
MAX_TAPS = 256          # out_size · sampling per axis (shared-memory table)


def _axis_weight_matrix(lo, bin_size, dim: int, stride: float,
                        out_size: int, sampling: int) -> torch.Tensor:
    """Per-box interpolation matrix along one axis, (B, R, out_size, dim):
    ``w(d) = Σ_s valid_s · max(0, 1 − |clamp(c_s) − d|) / sampling``, the
    tent form of the bilinear taps (reference ops/roi_align.py:75-103)."""
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


def axis_weights(feats, boxes, lvl, out_size: int, sampling: int,
                 min_level: int):
    """Per level: (wy (B, R, P, H_l) with other-level boxes zeroed,
    wx (B, R, P, W_l)), float32."""
    boxes = boxes.float()
    x0, y0 = boxes[..., 0], boxes[..., 1]
    bw = (boxes[..., 2] - boxes[..., 0]) / out_size
    bh = (boxes[..., 3] - boxes[..., 1]) / out_size
    out = []
    for li, f in enumerate(feats):
        H, W = f.shape[1], f.shape[2]
        stride = float(2 ** (min_level + li))
        wy = _axis_weight_matrix(y0, bh, H, stride, out_size, sampling)
        wx = _axis_weight_matrix(x0, bw, W, stride, out_size, sampling)
        wy = wy * (lvl == li)[..., None, None].to(wy.dtype)
        out.append((wy, wx))
    return out


def roi_align_fused_ref(feats, boxes, lvl, out_size: int, sampling: int,
                        min_level: int = 2) -> torch.Tensor:
    """The plain version: separable contractions per level, levels summed,
    in float32. feats: tuple of (B, H_l, W_l, C); boxes (B, R, 4) XYXY;
    lvl (B, R) level index per box. Returns (B, R, P, P, C) float32."""
    acc = None
    for f, (wy, wx) in zip(feats, axis_weights(feats, boxes, lvl, out_size,
                                               sampling, min_level)):
        t1 = torch.einsum("brph,bhwc->brpwc", wy, f.float())
        part = torch.einsum("brpwc,brqw->brpqc", t1, wx)
        acc = part if acc is None else acc + part
    return acc


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def build() -> dict:
    """Compile ``csrc/roi_align.cu`` into ``_build/`` unless a library of
    the same source and flags is there. Returns {"path", "seconds",
    "cached", "log"} (``log``: nvcc's output, with ptxas's register and
    spill counts)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"roi_align_{key[:16]}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "cached": True, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "cached": False,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.roi_align_bf16.argtypes = ([vp] * MAX_LEVELS + [i] * (2 * MAX_LEVELS)
                                   + [i, i, vp, vp, vp, i, i, i, i, i, i,
                                      vp])
    lib.roi_align_bf16.restype = i
    lib.roi_align_error_string.argtypes = [i]
    lib.roi_align_error_string.restype = ctypes.c_char_p
    return lib


def _check(feats, boxes, lvl, out_size, sampling):
    if not 1 <= len(feats) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels expected, got {len(feats)}")
    B, R = boxes.shape[:2]
    C = feats[0].shape[-1]
    dev = boxes.device
    for f in feats:
        if f.dim() != 4 or f.shape[0] != B or f.shape[-1] != C:
            raise ValueError(f"level shape {tuple(f.shape)} does not match "
                             f"(B={B}, H, W, C={C})")
        if f.dtype != torch.bfloat16:
            raise TypeError(f"levels must be bfloat16, got {f.dtype}")
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
    if not (1 <= sampling <= MAX_SAMPLING
            and 1 <= out_size * sampling <= MAX_TAPS):
        raise ValueError(f"unsupported out_size={out_size}, "
                         f"sampling={sampling}")


def roi_align_fused(feats, boxes, lvl, out_size: int, sampling: int,
                    min_level: int = 2) -> torch.Tensor:
    """Pool (B, R, P, P, C) from NHWC levels; same arguments as
    :func:`roi_align_fused_ref`. Launches the kernel for CUDA tensors
    (bf16 levels, bf16 out) and runs the plain version, cast to the
    feature dtype, for CPU tensors."""
    if boxes.device.type == "cpu":
        return roi_align_fused_ref(feats, boxes, lvl, out_size, sampling,
                                   min_level).to(feats[0].dtype)
    if boxes.device.type != "cuda":
        raise ValueError(f"no roi_align for {boxes.device.type} tensors")
    _check(feats, boxes, lvl, out_size, sampling)
    B, R = boxes.shape[:2]
    C = feats[0].shape[-1]
    out = torch.empty((B, R, out_size, out_size, C), dtype=torch.bfloat16,
                      device=boxes.device)
    if out.numel() == 0:
        return out
    n = len(feats)
    ptrs = [f.data_ptr() for f in feats] + [None] * (MAX_LEVELS - n)
    dims = []
    for li in range(MAX_LEVELS):
        dims += [feats[li].shape[1], feats[li].shape[2]] if li < n else [0, 0]
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = _library().roi_align_bf16(
        *ptrs, *dims, n, min_level, boxes.data_ptr(), lvl.data_ptr(),
        out.data_ptr(), B, R, C, out_size, sampling, boxes.device.index,
        stream)
    if rc != 0:
        raise RuntimeError("roi_align kernel launch failed: "
                           + _library().roi_align_error_string(rc).decode())
    roi_align_fused.launches += 1
    return out


roi_align_fused.launches = 0
