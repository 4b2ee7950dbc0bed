"""The conv epilogue: a conv's bias, then a residual or the coarser FPN
level, then ReLU, in one in-place pass over the conv's output. The Hopper
kernel's wrapper, its plain PyTorch version, and the check that decides
where a conv of the forward takes it.

Replaces no TPU kernel: XLA fuses the JAX package's bias adds, residual
sums and ReLUs into its convolutions. On the card PyTorch runs a cuDNN conv
without its bias and then adds the bias as a (1, C, 1, 1) operand broadcast
over the channels_last output, which keeps it off PyTorch's vectorised
path (a generic elementwise kernel, ~1.2 TB/s on an H100); each ReLU,
residual sum and FPN top-down sum is one more pass through device memory.
The kernel (``csrc/bias_act.cu``, built and loaded by
``ops/cuda_build.py``) does that work in one pass of 16-byte accesses,
bound by bytes: each output value read and written once, a residual read
once (~2.9 TB/s over a parity forward's calls on an H100 80GB HBM3 at
700 W, 87% of its 3.35 TB/s).

It computes what the sequence of PyTorch ops computes, bit for bit (each
add rounded to bf16 where PyTorch rounds it; :func:`bias_act_ref`):

- ``bias_act(y, b)``: ``y + b`` (a conv with its bias);
- ``relu=True``: then ``relu`` (a conv unit of the backbone);
- ``residual=x``: ``relu(bf16(y + b) + x)`` (the bottleneck's tail with
  the identity shortcut); with ``residual_bias=bs``, ``relu(bf16(y + b) +
  bf16(ysc + bs))`` (with the shortcut conv's output ``ysc`` as
  ``residual``);
- ``coarser=t``: ``bf16(y + b) + upsample2x_nearest(t)``, ``t`` read at
  ``(h // 2, w // 2)`` and never upsampled in memory (the FPN's lateral
  plus the top-down path).

:func:`conv_epilogue` runs a conv of the forward and what follows it. The
kernel engages (:func:`engages`) for an input on the card in bf16 with grad
off (inference); there the conv runs without its bias and the kernel does
the rest, and a map the kernel does not take raises. Everything else (the
CPU, float32, training) keeps the plain ops. ``counts`` counts the convs
on each side: each eager call once, and the calls of a CUDA graph once,
at its capture. ``launches`` counts the kernel's launches
(``ops.launch_counts``' "bias_act"), on the module, so that a stand-in for
:func:`bias_act` leaves it as it is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

MODES = {"bias": 0, "residual": 1, "residual_bias": 2, "coarser": 3}
MAX_C = 8192              # 8 channels a thread, at most 1024 threads a pixel
MAX_C_UNALIGNED = 1024    # one channel a thread (C not a multiple of 8)

# convs of the forward that took the kernel ("fused") or the plain ops
# ("plain"), and the kernel's launches
counts = {"fused": 0, "plain": 0}
launches = 0


def engages(x: torch.Tensor, convs: int = 1) -> bool:
    """Whether the ``convs`` convs that read ``x`` take the epilogue
    kernel: ``x`` on the card, bf16, with grad off. Counts them in
    ``counts``."""
    on = (x.is_cuda and x.dtype == torch.bfloat16
          and not torch.is_grad_enabled())
    counts["fused" if on else "plain"] += convs
    return on


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def conv_epilogue(conv_fn, x: torch.Tensor, bias: torch.Tensor,
                  relu: bool = False, residual: torch.Tensor | None = None,
                  shortcut: tuple | None = None,
                  coarser: torch.Tensor | None = None) -> torch.Tensor:
    """``conv_fn(x, bias)``, a conv of ``x`` with the bias ``bias`` (or
    none), then the residual ``residual``, or the output of the shortcut
    conv ``shortcut = (conv_fn, input, bias)``, or the coarser FPN level's
    nearest 2x upsample, then ReLU where ``relu``. Where the kernel engages
    the convs run without their biases and one pass of :func:`bias_act`
    does the rest in place; elsewhere the plain ops."""
    if engages(x, 1 if shortcut is None else 2):
        y = conv_fn(x, None)
        if shortcut is None:
            return bias_act(y, bias, relu, residual=residual,
                            coarser=coarser)
        sc_fn, sc_x, sc_b = shortcut
        return bias_act(y, bias, relu, residual=sc_fn(sc_x, None),
                        residual_bias=sc_b)
    y = conv_fn(x, bias)
    if shortcut is not None:
        sc_fn, sc_x, sc_b = shortcut
        residual = sc_fn(sc_x, sc_b)
    if residual is not None:
        y = y + residual
    if coarser is not None:
        y = y + upsample2x_nearest(coarser)
    return torch.relu_(y) if relu else y


def bias_act_ref(y: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                 residual: torch.Tensor | None = None,
                 residual_bias: torch.Tensor | None = None,
                 coarser: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version, the PyTorch ops the kernel replaces: returns a
    new tensor."""
    out = y + bias[:, None, None]
    if residual is not None:
        out = out + (residual if residual_bias is None
                     else residual + residual_bias[:, None, None])
    if coarser is not None:
        out = out + upsample2x_nearest(coarser)
    return torch.relu(out) if relu else out


def _nhwc(t: torch.Tensor) -> bool:
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def _check(y, bias, residual, residual_bias, coarser):
    """Refuse what the kernel does not take: tensors on another device
    than ``y``'s, not bf16, ``y`` and the maps not (N, C, H, W) in
    channels_last memory, a bias that is not (C,) and contiguous, a
    residual not of ``y``'s shape, a coarser level not (N, C, H/2, W/2)
    with H and W even, C beyond the kernel's block."""
    maps = [t for t in (residual, coarser) if t is not None]
    vecs = [t for t in (bias, residual_bias) if t is not None]
    for t in (y, *maps, *vecs):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"bias_act takes bf16 tensors, got {t.dtype}")
        if t.device != y.device:
            raise ValueError("bias_act's tensors must be on one device")
    for t in (y, *maps):
        if not _nhwc(t):
            raise ValueError(f"bias_act takes (N, C, H, W) maps in "
                             f"channels_last memory, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    N, C, H, W = y.shape
    for t in vecs:
        if t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"a bias must be contiguous ({C},), got "
                             f"{tuple(t.shape)}")
    if residual is not None and coarser is not None:
        raise ValueError("bias_act takes a residual or a coarser level, "
                         "not both")
    if residual_bias is not None and residual is None:
        raise ValueError("residual_bias needs a residual")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"residual {tuple(residual.shape)} is not "
                         f"{tuple(y.shape)}")
    if coarser is not None and (H % 2 or W % 2 or coarser.shape
                                != (N, C, H // 2, W // 2)):
        raise ValueError(f"coarser level {tuple(coarser.shape)} is not "
                         f"half of {tuple(y.shape)}")
    if C > (MAX_C if C % 8 == 0 else MAX_C_UNALIGNED):
        raise ValueError(f"{C} channels: at most {MAX_C} (a multiple of 8) "
                         f"or {MAX_C_UNALIGNED}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("bias_act")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bias_act_bf16.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, i, i, i,
                                  i, i, i, vp]
    lib.bias_act_bf16.restype = i
    return lib


def bias_act(y: torch.Tensor, bias: torch.Tensor, relu: bool = False,
             residual: torch.Tensor | None = None,
             residual_bias: torch.Tensor | None = None,
             coarser: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the epilogue to ``y`` in place on the card and return it; the
    arguments as :func:`bias_act_ref` takes them. Raises for tensors off
    the card and for what the kernel does not take (:func:`_check`)."""
    global launches
    if y.device.type != "cuda":
        raise ValueError(f"bias_act runs on CUDA tensors, got "
                         f"{y.device.type}")
    _check(y, bias, residual, residual_bias, coarser)
    if y.numel() == 0:
        return y
    if coarser is not None:
        mode, r = MODES["coarser"], coarser
    elif residual is not None:
        mode = MODES["residual" if residual_bias is None else "residual_bias"]
        r = residual
    else:
        mode, r = MODES["bias"], None
    N, C, H, W = y.shape
    rc = _library().bias_act_bf16(
        y.data_ptr(), bias.data_ptr(), None if r is None else r.data_ptr(),
        None if residual_bias is None else residual_bias.data_ptr(),
        N * H * W, C, H, W, mode, int(relu), y.device.index,
        torch.cuda.current_stream(y.device).cuda_stream)
    cuda_build.check("bias_act", rc, "bias_act")
    launches += 1
    return y
