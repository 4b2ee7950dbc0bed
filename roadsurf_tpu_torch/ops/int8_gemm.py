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
takes any (M, K, N): the kernel masks the ragged tiles.

What bounds it on an H100: at the backbone's 1x1 shapes (K, N ≤ 2048)
bytes, at box FC1 (K = 12544) the int8 tensor cores (``chip_smoke.py``
computes both bounds from each run's shapes). The design is the simple
one that is right first: ``mma.sync`` m16n8k32 int8 tiles of 128 x 128 a
block, a 64-deep K slice staged through registers into shared memory with
the next slice's loads in flight, w transposed to (n, k) on the way so both
operands' fragments are 32-bit loads, int32 accumulators in registers and
the epilogue applied to them before the only store. TMA, ``wgmma`` and a
deeper pipeline are later work. The kernel source is
``csrc/int8_gemm.cu``, built and loaded by ``ops/cuda_build.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

_MODES = {"raw": 0, "bf16": 1, "int8": 2}


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
    lib.int8_gemm_run.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
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
    M, N = a.shape[0], w.shape[1]
    if mult is not None and bias is None:
        bias = torch.zeros(N, dtype=torch.float32, device=a.device)
    out = torch.empty((M, N), device=a.device, dtype={
        "raw": torch.int32, "bf16": torch.bfloat16, "int8": torch.int8}[mode])
    rc = _library().int8_gemm_run(
        a.data_ptr(), w.data_ptr(),
        None if mult is None else mult.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), M,
        a.shape[1], N, _MODES[mode], int(relu), a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check("int8_gemm", rc, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
