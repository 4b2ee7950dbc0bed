"""int8 x int8 -> int32 GEMM with the static-int8 epilogue fused: the Hopper
kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``int8_gemm`` of the reference package
(roadsurf_tpu/ops/int8_gemm.py:79), with its semantics (the epilogue of
``models/quant.py``'s int8 convs)::

    acc = Σ_k a[m, k] · w[k, n]                     int32, exact
    y   = acc · mult[n] + bias[n]                    float32
    y   = max(y, 0)                                  if relu
    out = clip(round(y), -127, 127) int8             if quantize
        | y bf16                                     otherwise

and with ``mult=None`` the raw int32 ``acc``. A consumer's scale folds
in as ``mult/sa_out``, ``bias/sa_out`` with ``quantize=True``. Like the
reference it is an op of its own: no ``models/`` path calls it, in either
package; the 1x1 convs and box FC1 of the int8 stack are its shapes. It
takes any (M, K, N).

What bounds it on an H100: at the backbone's 1x1 shapes (K ≤ 2048) bytes,
mostly the output's; at box FC1 (K = 12544) the int8 tensor cores, fed
from L2 (``chip_smoke.py`` computes both bounds from each run's shapes).
The design (the note in ``csrc/int8_gemm.cu`` has the details):
``wgmma`` m64nNk32 int8 products from shared memory, fed by a ring of
128-deep K slices that one producer warp fills with TMA tensor copies
(128-byte swizzle, completion on mbarriers), two consumer warpgroups of 64
rows each over a 128 × BN tile (BN = 64 for N ≤ 64, else 128), two blocks
an SM; the epilogue staged in shared memory and stored 16 bytes a thread.
Int8 ``wgmma`` reads both operands K-major, so the call first writes w's
transpose (N, Kp) into scratch the wrapper allocates (Kp = K rounded up to
``PAD_K``, zero-padded); where ``a`` is not 16-byte aligned or K is not a
multiple of ``PAD_K`` (TMA's stride rule) it also copies ``a`` into
zero-padded (M, Kp) scratch (``needs_pad``). The tiles past M, N and K are
zero-filled by the TMA unit, so any (M, K, N) is taken. The kernel source
is ``csrc/int8_gemm.cu``, built and loaded by ``ops/cuda_build.py``; the
layout constants here are read from it (``KERNEL``).
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from . import cuda_build

_MODES = {"raw": 0, "bf16": 1, "int8": 2}
# the layout constants of csrc/int8_gemm.cu, read from its source
KERNEL = {name: int(v) for name, v in re.findall(
    r"^constexpr int (k\w+) = (\d+);",
    (cuda_build.CSRC / "int8_gemm.cu").read_text(), re.M)}
PAD_K = KERNEL["kPadK"]     # K of the TMA-read copies, rounded up to this


def padded_k(K: int) -> int:
    """Kp: the K extent of w's transpose (and of a's padded copy)."""
    return -(-K // PAD_K) * PAD_K


def needs_pad(a) -> bool:
    """Whether the kernel reads ``a`` through a zero-padded (M, Kp) copy:
    TMA takes 16-byte aligned bases and row strides only (``needs_pad``
    in the kernel source)."""
    return a.shape[1] % PAD_K != 0 or a.data_ptr() % 16 != 0


def _mode(mult, quantize: bool) -> str:
    if mult is None:
        if quantize:
            raise ValueError("quantize needs mult")
        return "raw"
    return "int8" if quantize else "bf16"


def int8_gemm_ref(a, w, mult=None, bias=None, relu: bool = False,
                  quantize: bool = False) -> torch.Tensor:
    """The plain version: the integer product in float64 (exact: |acc| ≤
    K·127² < 2⁵³, and the card has no int32 matmul), then the epilogue as
    separate float32 operations. Returns (M, N) int32, bf16 or int8."""
    acc = (a.double() @ w.double()).to(torch.int32)
    if mult is None:
        return acc
    y = acc.float() * mult.float()
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = y.clamp(min=0.0)
    if quantize:
        return torch.round(y).clamp(-127.0, 127.0).to(torch.int8)
    return y.to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("int8_gemm")
    lib.int8_gemm_run.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.int8_gemm_run.restype = ctypes.c_int
    return lib


def _check(a, w, mult, bias):
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"a and w must be int8, got {a.dtype}, {w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0] \
            or 0 in a.shape or w.shape[1] == 0:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(w.shape)} are "
                         "not (M, K) x (K, N)")
    if not (a.is_contiguous() and w.is_contiguous()) \
            or w.device != a.device:
        raise ValueError("a and w must be contiguous and on one device")
    N = w.shape[1]
    for v in (mult, bias):
        if v is not None and (v.dtype != torch.float32 or v.shape != (N,)
                              or v.device != a.device
                              or not v.is_contiguous()):
            raise ValueError(f"mult and bias must be contiguous float32 "
                             f"({N},) on a's device")
    if bias is not None and mult is None:
        raise ValueError("bias needs mult")


def int8_gemm(a, w, mult=None, bias=None, relu: bool = False,
              quantize: bool = False) -> torch.Tensor:
    """a (M, K) int8, w (K, N) int8, mult and bias (N,) float32 -> (M, N):
    int32 (``mult`` None), bf16 (``mult`` given), or int8 (``quantize``).
    Launches the kernel for CUDA tensors and runs the plain version for
    CPU tensors."""
    mode = _mode(mult, quantize)
    if a.device.type == "cpu":
        return int8_gemm_ref(a, w, mult, bias, relu, quantize)
    if a.device.type != "cuda":
        raise ValueError(f"no int8_gemm for {a.device.type} tensors")
    _check(a, w, mult, bias)
    (M, K), N = a.shape, w.shape[1]
    if mult is not None and bias is None:
        bias = torch.zeros(N, dtype=torch.float32, device=a.device)
    out = torch.empty((M, N), device=a.device, dtype={
        "raw": torch.int32, "bf16": torch.bfloat16, "int8": torch.int8}[mode])
    # scratch in one allocation: w's transpose (N, Kp), then a's padded
    # copy (M, Kp) where TMA cannot read a; N·Kp keeps the copy 16-byte
    # aligned
    Kp = padded_k(K)
    pad = needs_pad(a)
    scratch = torch.empty((N + (M if pad else 0)) * Kp, dtype=torch.int8,
                          device=a.device)
    wt = scratch.data_ptr()
    rc = _library().int8_gemm_run(
        a.data_ptr(), w.data_ptr(),
        None if mult is None else mult.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), wt,
        wt + N * Kp if pad else None, M, K, N,
        _MODES[mode], int(relu), a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check("int8_gemm", rc, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
