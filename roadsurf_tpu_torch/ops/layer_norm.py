"""ViTDet's LayerNorms over the channels of (B, H, W, C) rows, with the
residual sum before them, the window pad after them and the ReLU or GELU
that follows: the Hopper kernel's wrapper (``csrc/layer_norm.cu``, K8),
its plain PyTorch version, and the check that decides which one a call
takes.

Replaces no TPU kernel: the JAX package has no ViT and no LayerNorm. On
the card PyTorch runs each LN as ATen's ``vectorized_layer_norm_kernel``,
a whole block a row, which at ViTDet's widths (C = 256, 384, 768) is bound
by launching and reducing blocks, not by bytes (27% of its byte bound over
a ViTDet-B forward on an H100 80GB HBM3 at 700 W); the residual sum before
a block's norm (the windowed blocks' a padded slice, through ATen's generic
elementwise kernel), the pad after a windowed block's ``norm1``, the
heads' ReLU and the pyramid's GELU are one more pass each. The kernel does
each LN and its neighbours in one pass bound by bytes: each input value
read once and each output value written once, ~1.09 GB a 1024 px tile
over a forward's 41 calls, ~325 µs at 3.35 TB/s.

:func:`layer_norm` computes, for rows ``x`` (B, H, W, C) with the LN's
``w`` and ``b`` (:func:`layer_norm_ref`, the composition of PyTorch ops):

- ``s = x + residual`` where a residual is given (a (B, H, W, C) view at
  any row strides, e.g. a slice of a padded grid), else ``s = x``;
- ``y = act(layer_norm(s))``, ``act`` None, "relu" or "gelu" (exact);
- with ``pad_to=(Hp, Wp)``, ``y`` zero-padded to (B, Hp, Wp, C) at the
  bottom and right (``F.pad``);

and returns ``(s, y)``. The kernel engages (:func:`engages`) for ``x`` on
the card in bf16 with grad off and C one of ViTDet-B's ``WIDTHS``
(inference); there rows the kernel does not take raise. Everything else
(the CPU, float32, training) takes the plain version. The kernel writes
``s`` as PyTorch's bf16 add does, bit for bit; ``y`` from float32
statistics (mean, then the centred variance) of ``s``, rounded to bf16
before the activation as the composition rounds it. ``counts`` counts the
calls on each side ("fused", "plain"); ``launches`` the kernel's launches
(``ops.launch_counts``' "layer_norm").
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

ACTS = {None: 0, "relu": 1, "gelu": 2}
# the widths the kernel is built for, each row split exactly into lanes of
# 16-byte vectors: the ViT's 768, P2's LN at 384, the pyramid's and the
# heads' 256
WIDTHS = (256, 384, 768)
MAX_ROWS = 2 ** 31 - 1      # output rows of a call (B · Hp · Wp), at most

# LN calls that took the kernel ("fused") or the plain version ("plain"),
# and the kernel's launches
counts = {"fused": 0, "plain": 0}
launches = 0


def engages(x: torch.Tensor) -> bool:
    """Whether an LN of rows ``x`` takes the kernel: on the card, bf16,
    with grad off, C one of ``WIDTHS``. Counts the call in ``counts``."""
    on = (x.is_cuda and x.dtype == torch.bfloat16
          and not torch.is_grad_enabled() and x.shape[-1] in WIDTHS)
    counts["fused" if on else "plain"] += 1
    return on


def layer_norm_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float, residual: torch.Tensor | None = None,
                   act: str | None = None, pad_to: tuple | None = None):
    """The plain version, the PyTorch ops the kernel replaces: the
    arguments as :func:`layer_norm` takes them -> (s, y)."""
    s = x if residual is None else x + residual
    y = F.layer_norm(s, (s.shape[-1],), w, b, eps)
    if act == "relu":
        y = torch.relu(y)
    elif act == "gelu":
        y = F.gelu(y)
    elif act is not None:
        raise ValueError(f"activation {act!r}: one of {list(ACTS)}")
    if pad_to is not None:
        (Hp, Wp), (H, W) = pad_to, s.shape[1:3]
        if (Hp, Wp) != (H, W):
            y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
    return s, y


def _rows(t: torch.Tensor) -> bool:
    """(B, H, W, C) with C contiguous and every row 16 bytes aligned."""
    return (t.dim() == 4 and t.stride(3) == 1
            and all(st % 8 == 0 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check(x, w, b, residual, act, pad_to):
    """Refuse what the kernel does not take: tensors off ``x``'s card or
    not bf16, rows that are not (B, H, W, C) with C contiguous and 16-byte
    aligned rows, a residual of another shape, ``w`` or ``b`` not a
    contiguous, aligned (C,), C not one of ``WIDTHS``, a
    pad smaller than the grid, more than ``MAX_ROWS`` rows, an unknown
    activation."""
    maps = [t for t in (x, residual) if t is not None]
    for t in (*maps, w, b):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"layer_norm takes bf16 tensors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("layer_norm's tensors must be on one device")
    for t in maps:
        if not _rows(t):
            raise ValueError(f"layer_norm takes (B, H, W, C) rows with C "
                             f"contiguous and 16-byte aligned, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    B, H, W, C = x.shape
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} is not "
                         f"{tuple(x.shape)}")
    for t in (w, b):
        if t.shape != (C,) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w and b must be contiguous, 16-byte aligned "
                             f"({C},), got {tuple(t.shape)}")
    if C not in WIDTHS:
        raise ValueError(f"{C} channels: one of {WIDTHS}")
    Hp, Wp = (H, W) if pad_to is None else pad_to
    if Hp < H or Wp < W:
        raise ValueError(f"pad_to {tuple(pad_to)} is smaller than the "
                         f"{H}x{W} grid")
    if B * Hp * Wp > MAX_ROWS:
        raise ValueError(f"{B * Hp * Wp} rows: at most {MAX_ROWS} a call")
    if act not in ACTS:
        raise ValueError(f"activation {act!r}: one of {list(ACTS)}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("layer_norm")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.layer_norm_bf16.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ll, ll,
                                    ll, ll, i, i, i, i, i, i,
                                    ctypes.c_float, i, i, vp]
    lib.layer_norm_bf16.restype = i
    return lib


def layer_norm_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float, residual: torch.Tensor | None = None,
                    act: str | None = None, pad_to: tuple | None = None):
    """The kernel: the arguments as :func:`layer_norm_ref` takes them ->
    (s, y), both new contiguous bf16 tensors (``s`` is ``x`` without a
    residual). Raises for tensors off the card and for what the kernel
    does not take (:func:`_check`)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on CUDA tensors, got "
                         f"{x.device.type}")
    _check(x, w, b, residual, act, pad_to)
    B, H, W, C = x.shape
    Hp, Wp = (H, W) if pad_to is None else pad_to
    y = torch.empty((B, Hp, Wp, C), dtype=x.dtype, device=x.device)
    s = x if residual is None else torch.empty((B, H, W, C), dtype=x.dtype,
                                               device=x.device)
    if x.numel() == 0:
        return s, y.zero_()
    r = residual
    rs = (0, 0, 0) if r is None else r.stride()[:3]
    rc = _library().layer_norm_bf16(
        x.data_ptr(), None if r is None else r.data_ptr(),
        None if r is None else s.data_ptr(), y.data_ptr(), w.data_ptr(),
        b.data_ptr(), *x.stride()[:3], *rs, B, H, W, Hp, Wp, C, float(eps),
        ACTS[act], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check("layer_norm", rc, "layer_norm")
    launches += 1
    return s, y


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float, residual: torch.Tensor | None = None,
               act: str | None = None, pad_to: tuple | None = None):
    """LN over the last dim of rows ``x`` (B, H, W, C), with the residual
    sum before it, the activation and the pad after it (the module's
    docstring) -> (s, y). The kernel where it engages (:func:`engages`),
    else the plain version."""
    if engages(x):
        return layer_norm_rows(x, w, b, eps, residual, act, pad_to)
    return layer_norm_ref(x, w, b, eps, residual, act, pad_to)
