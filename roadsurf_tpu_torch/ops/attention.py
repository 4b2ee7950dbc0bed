"""ViTDet's attention with decomposed relative position, windowed or
global: the Hopper kernel's wrapper (``csrc/rel_attention.cu``, K7), its
plain PyTorch version, and the check that decides which one a call takes.

Replaces no TPU kernel: the JAX package has no ViT. It computes what
detectron2's ``Attention`` computes (``modeling/backbone/vit.py``, with
``utils.py``'s ``get_rel_pos`` and ``add_decomposed_rel_pos``) on each
window of the token grid: ``softmax((q · scale) kᵀ + rel_h[i, row(j)] +
rel_w[i, col(j)]) v``, where ``rel_h[i, kh] = q_i · Rh[row(i), kh]`` with
the unscaled ``q`` and ``Rh[a, b] = rel_pos_h[a − b + ws − 1]`` (the same
for columns). A window of side ``ws`` is a ``ws × ws`` block of the grid
(the padded tokens of a windowed block are keys like any other); the
global attention is one window over the whole grid.

The two tables come from a small batched product outside the kernel
(:func:`rel_tables`, ``(B, Hp, Wp, heads, ws)`` each); the kernel adds them
to its float32 scores and runs an online softmax, so no N × N score or bias
tensor is ever in device memory (a global block's would be 403 MB a tile in
bf16). :func:`attention` engages the kernel (:func:`engages`) for ``qkv``
on the card in bf16 with grad off; the CPU, float32 and training take
:func:`rel_attention_ref`, the materialised form. ``counts`` counts the
calls on each side ("fused", "plain"); ``launches`` the kernel's launches
(``ops.launch_counts``' "rel_attention"), and ``path_launches`` each of
its two tilings' (:func:`path`): "row" where a window is 64 tokens wide (a
key step is two rows of the grid; ViTDet's global blocks at 1024 px),
"window" below (a key step is a block of the window's rows; ViTDet's
windows of 14 are one step). ``ops.reset_launch_counts`` resets both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

HEAD_DIM = 64        # the kernel's head dim
MAX_WINDOW = 64      # a window's side, at most, in the kernel
MAX_WINDOWS = 65535  # windows of a call (B · windows an image), at most
# the plain version's scores a chunk of windows, at most (float32 values)
REF_CHUNK = 1 << 28

# attention calls that took the kernel ("fused") or the plain version
# ("plain"), the kernel's launches, and its launches by path
counts = {"fused": 0, "plain": 0}
launches = 0
path_launches = {"row": 0, "window": 0}


def engages(qkv: torch.Tensor) -> bool:
    """Whether an attention call on ``qkv`` takes the kernel: on the card,
    bf16, with grad off. Counts the call in ``counts``."""
    on = (qkv.is_cuda and qkv.dtype == torch.bfloat16
          and not torch.is_grad_enabled())
    counts["fused" if on else "plain"] += 1
    return on


@functools.lru_cache(maxsize=None)
def _rel_index(ws: int, device: torch.device) -> torch.Tensor:
    """(ws, ws) ``a − b + ws − 1``: ``get_rel_pos``' index for a query and
    a key window of one size."""
    a = torch.arange(ws)
    return (a[:, None] - a[None, :] + ws - 1).to(device)


def rel_tables(q: torch.Tensor, rel_pos_h: torch.Tensor,
               rel_pos_w: torch.Tensor, ws: int):
    """``q`` (B, Hp, Wp, heads, d), unscaled -> (rel_h, rel_w), each (B,
    Hp, Wp, heads, ws) contiguous in ``q``'s dtype: each token's q against
    the rows (columns) of its window's relative-position table,
    ``rel_pos_h`` (2·ws − 1, d)."""
    B, Hp, Wp, nh, d = q.shape
    if rel_pos_h.shape != (2 * ws - 1, d) or rel_pos_w.shape != (2 * ws - 1,
                                                                  d):
        raise ValueError(f"relative-position tables must be ({2 * ws - 1}, "
                         f"{d}) for windows of {ws}, got "
                         f"{tuple(rel_pos_h.shape)}, {tuple(rel_pos_w.shape)}")
    idx = _rel_index(ws, q.device)
    Rh = rel_pos_h.to(q.dtype)[idx]                       # (ws, ws, d)
    Rw = rel_pos_w.to(q.dtype)[idx]
    rel_h = torch.einsum("byixhc,ikc->byixhk",
                         q.reshape(B, Hp // ws, ws, Wp, nh, d), Rh)
    rel_w = torch.einsum("byxjhc,jkc->byxjhk",
                         q.reshape(B, Hp, Wp // ws, ws, nh, d), Rw)
    return rel_h.reshape(B, Hp, Wp, nh, ws).contiguous(), \
        rel_w.reshape(B, Hp, Wp, nh, ws).contiguous()


def _windows(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, Hp, Wp, heads, e) -> (B · windows, heads, ws², e), windows and
    their tokens in detectron2's ``window_partition`` order."""
    B, Hp, Wp, nh, e = t.shape
    return t.reshape(B, Hp // ws, ws, Wp // ws, ws, nh, e) \
        .permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, nh, ws * ws, e)


def rel_attention_ref(qkv: torch.Tensor, rel_h: torch.Tensor,
                      rel_w: torch.Tensor, ws: int,
                      scale: float) -> torch.Tensor:
    """The plain version: ``qkv`` (B, Hp, Wp, 3, heads, d), the tables of
    :func:`rel_tables` -> (B, Hp, Wp, heads · d) in ``qkv``'s dtype, from
    materialised float32 scores, a chunk of windows at a time."""
    B, Hp, Wp, _, nh, d = qkv.shape
    q, k, v = (_windows(qkv[:, :, :, i].float(), ws) for i in range(3))
    rh, rw = _windows(rel_h.float(), ws), _windows(rel_w.float(), ws)
    G, N = q.shape[0], ws * ws
    out = torch.empty_like(q)
    step = max(1, REF_CHUNK // (nh * N * N))
    for s in range(0, G, step):
        sl = slice(s, s + step)
        attn = (q[sl] * scale) @ k[sl].transpose(-2, -1)
        attn = (attn.view(-1, nh, N, ws, ws) + rh[sl][..., :, None]
                + rw[sl][..., None, :]).view(-1, nh, N, N)
        out[sl] = attn.softmax(dim=-1) @ v[sl]
    out = out.view(B, Hp // ws, Wp // ws, nh, ws, ws, d) \
        .permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, nh * d)
    return out.to(qkv.dtype)


def path(ws: int) -> str:
    """The kernel's tiling for windows of ``ws``: "row" at 64, the widest
    (a key step is two rows of the grid, 128 keys), "window" below (a key
    step is a block of the window's rows, the whole window up to 14)."""
    return "row" if ws == MAX_WINDOW else "window"


def _check(qkv, rel_h, rel_w, ws):
    """Refuse what the kernel does not take: tensors off ``qkv``'s card or
    not bf16, ``qkv`` not a contiguous (B, Hp, Wp, 3, heads, 64) from a
    16-byte aligned address (its tensor map's base), tables not contiguous
    (B, Hp, Wp, heads, ws) from a 4-byte aligned one, a grid that windows
    of ``ws`` do not tile, ``ws`` odd or above 64, more than 65535
    windows."""
    for t in (qkv, rel_h, rel_w):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"rel_attention takes bf16 tensors, got "
                            f"{t.dtype}")
        if t.device != qkv.device:
            raise ValueError("rel_attention's tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("rel_attention takes contiguous tensors")
        if t.data_ptr() % (16 if t is qkv else 4):
            raise ValueError(f"rel_attention takes qkv 16-byte and the "
                             f"tables 4-byte aligned, got an address "
                             f"{t.data_ptr() % 16} bytes past 16")
    if qkv.dim() != 6 or qkv.shape[3] != 3 or qkv.shape[5] != HEAD_DIM:
        raise ValueError(f"qkv must be (B, Hp, Wp, 3, heads, {HEAD_DIM}), "
                         f"got {tuple(qkv.shape)}")
    B, Hp, Wp, _, nh, _ = qkv.shape
    for t in (rel_h, rel_w):
        if t.shape != (B, Hp, Wp, nh, ws):
            raise ValueError(f"a table must be {(B, Hp, Wp, nh, ws)}, got "
                             f"{tuple(t.shape)}")
    if ws < 2 or ws % 2 or ws > MAX_WINDOW or Hp % ws or Wp % ws:
        raise ValueError(f"windows of {ws} on a {Hp}x{Wp} grid: the kernel "
                         f"takes an even side of at most {MAX_WINDOW} that "
                         f"tiles the grid")
    if B * (Hp // ws) * (Wp // ws) > MAX_WINDOWS:
        raise ValueError(f"{B * (Hp // ws) * (Wp // ws)} windows: at most "
                         f"{MAX_WINDOWS} a call")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("rel_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rel_attention_bf16.argtypes = [vp, vp, vp, vp, i, i, i, i, i,
                                       ctypes.c_float, i, vp]
    lib.rel_attention_bf16.restype = i
    return lib


def rel_attention(qkv: torch.Tensor, rel_h: torch.Tensor,
                  rel_w: torch.Tensor, ws: int, scale: float) -> torch.Tensor:
    """The kernel: the arguments as :func:`rel_attention_ref` takes them
    -> a new (B, Hp, Wp, heads · 64) bf16 tensor. Raises for tensors off
    the card and for what the kernel does not take (:func:`_check`).
    Counts the launch in ``launches`` and in ``path_launches`` by its
    :func:`path`."""
    global launches
    if qkv.device.type != "cuda":
        raise ValueError(f"rel_attention runs on CUDA tensors, got "
                         f"{qkv.device.type}")
    _check(qkv, rel_h, rel_w, ws)
    B, Hp, Wp, _, nh, d = qkv.shape
    out = torch.empty((B, Hp, Wp, nh * d), dtype=qkv.dtype,
                      device=qkv.device)
    rc = _library().rel_attention_bf16(
        qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
        B, Hp, Wp, ws, nh, float(scale), qkv.device.index,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    cuda_build.check("rel_attention", rc, "rel_attention")
    launches += 1
    path_launches[path(ws)] += 1
    return out


def attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
              rel_pos_w: torch.Tensor, heads: int, ws: int) -> torch.Tensor:
    """ViTDet's attention over windows of side ``ws`` of a token grid:
    ``qkv`` (B, Hp, Wp, 3 · C), the qkv linear's output (Hp and Wp
    multiples of ``ws``; ``ws`` = Hp = Wp for the global attention) ->
    (B, Hp, Wp, C), before the output projection. The kernel where it
    engages (:func:`engages`), else the plain version."""
    B, Hp, Wp, C3 = qkv.shape
    d = C3 // 3 // heads
    qkv = qkv.view(B, Hp, Wp, 3, heads, d)
    rel_h, rel_w = rel_tables(qkv[:, :, :, 0], rel_pos_h, rel_pos_w, ws)
    if engages(qkv):
        return rel_attention(qkv, rel_h, rel_w, ws, d ** -0.5)
    return rel_attention_ref(qkv, rel_h, rel_w, ws, d ** -0.5)
