"""ViTDet's backbone and neck: a plain ViT with windowed and global
attention, and the simple feature pyramid (``ModelConfig(backbone="vit")``,
``config.vitdet_b``).

One contract differs from detectron2's ``Block``: a block's output is the
pair ``(x', m)`` whose sum is the block's output, the MLP's output ``m``
being summed by the next block's ``norm1`` in its LayerNorm pass. Run
blocks through :func:`run_blocks` (or :func:`vit_forward`), which adds the
last ``m``; ``_block`` is not a public entry point.

Port of detectron2's ``modeling/backbone/vit.py`` (``ViT``, ``Block``,
``Attention``, ``SimpleFeaturePyramid``) and ``utils.py``
(``window_partition``, ``get_abs_pos``) at inference: patch embedding (a
patch-sized conv with stride the patch), the absolute position embedding
resized bicubically from its pretraining grid, pre-LN blocks (LN, attention
with decomposed relative position in windows or over the whole grid, LN,
MLP with exact GELU) with no final norm; a windowed block pads the grid with
zeros after ``norm1`` to a multiple of the window, and the padded tokens
are keys like any other. The pyramid reads the last map at stride 16: P2 by
two 2x2 deconvs (channel LN and GELU between), P3 by one, P4 the map, P5 a
2x2 max-pool; each then a 1x1 and a 3x3 conv, both without bias and each
followed by a channel LN; P6 the stride-2 subsample of P5.

Tokens are NHWC, (B, H, W, C), in the compute dtype; the pyramid's levels
are NCHW in channels_last memory, as the FPN's. Every conv with a bias (the
patch embedding, the deconvs) goes through ``ops.bias_act.conv_epilogue``;
the convs without bias, each followed by a LN, stay plain. Every LN goes
through ``ops.layer_norm.layer_norm`` (K8 on the card) with its neighbours:
a block's residual sums before its norms (the MLP's output is left to the
next block's ``norm1``), the windowed blocks' pad after ``norm1``, the
heads' ReLU and the pyramid's GELU after theirs. The MLP's GELU is ATen's;
the attention is ``ops.attention.attention`` (K7 on the card).

The state (``state["backbone"]``, ``state["fpn"]``), in the program's
inference layout (convs OIHW, deconvs (in, out, kh, kw), linears (out,
in)):

* ``backbone``: ``patch_embed`` {w, b}; ``pos_embed`` (1, 1 + G², C) at the
  pretraining grid G with its class token; ``blocks``, one dict a block:
  ``norm1``, ``norm2`` {w, b}; ``qkv``, ``proj``, ``fc1``, ``fc2`` {w, b};
  ``rel_pos_h``, ``rel_pos_w`` (2·s − 1, C / heads), s the window's side or,
  in a global block, the grid's;
* ``fpn``: ``p2`` .. ``p5``, each ``lateral`` and ``output`` {w} with
  ``lateral_norm`` and ``output_norm`` {w, b}; ``p2`` and ``p3`` also
  ``deconv1`` {w, b}, ``p2`` ``norm`` {w, b} and ``deconv2`` {w, b}.

:func:`prepare` resizes the position embedding to the input's grid once,
when the state is placed (``mask_rcnn.prepare_state``), as
``backbone["pos_grid"]`` (1, H·W, C).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.bias_act import conv_epilogue
from ..ops.layer_norm import layer_norm
from ..utils.profiling import span

LEVELS = ("p2", "p3", "p4", "p5")


def ln2d(x: torch.Tensor, p: dict, eps: float,
         act: str | None = None) -> torch.Tensor:
    """detectron2's channel LayerNorm of an NCHW map in channels_last
    memory, then ``act`` ("relu", "gelu" or none): LN over C of the NHWC
    view, returned as an NCHW view."""
    _, y = layer_norm(x.permute(0, 2, 3, 1), p["w"], p["b"], eps, act=act)
    return y.permute(0, 3, 1, 2)


def conv_ln_relu(x: torch.Tensor, p: dict, norm: dict,
                 eps: float) -> torch.Tensor:
    """A head's conv without bias (k//2 padding), its channel LN, ReLU."""
    y = F.conv2d(x, p["w"], padding=p["w"].shape[-1] // 2)
    return ln2d(y, norm, eps, act="relu")


def _deconv(x: torch.Tensor, p: dict) -> torch.Tensor:
    """A 2x2 stride-2 transposed conv with its bias."""
    return conv_epilogue(lambda t, b: F.conv_transpose2d(t, p["w"], b,
                                                         stride=2),
                         x, p["b"])


def abs_pos(pos_embed: torch.Tensor, grid: int) -> torch.Tensor:
    """``get_abs_pos``: (1, 1 + G², C) with a class token -> (1, grid²,
    C), bicubic (``align_corners=False``) in float32 where G differs from
    ``grid``, in ``pos_embed``'s dtype."""
    t = pos_embed[:, 1:]
    G = math.isqrt(t.shape[1])
    if G * G != t.shape[1]:
        raise ValueError(f"position embedding of {t.shape[1]} tokens is not "
                         f"a square grid")
    if G != grid:
        t = F.interpolate(t.float().reshape(1, G, G, -1).permute(0, 3, 1, 2),
                          size=(grid, grid), mode="bicubic",
                          align_corners=False).permute(0, 2, 3, 1)
    return t.reshape(1, grid * grid, -1).to(pos_embed.dtype).contiguous()


def grid_of(cfg) -> int:
    """The token grid's side at the config's input."""
    if cfg.min_size_test % cfg.vit_patch:
        raise ValueError(f"input {cfg.min_size_test} is not a multiple of "
                         f"the patch {cfg.vit_patch}")
    return cfg.min_size_test // cfg.vit_patch


def prepare(state: dict, cfg) -> dict:
    """The state with ``backbone["pos_grid"]``, the position embedding at
    the input's grid (:func:`abs_pos`); a state that has it passes
    through."""
    bb = state["backbone"]
    grid = grid_of(cfg)
    pos = bb.get("pos_grid")
    if pos is not None and pos.shape[1] == grid * grid:
        return state
    return dict(state, backbone=dict(bb, pos_grid=abs_pos(bb["pos_embed"],
                                                          grid)))


def _block(x: torch.Tensor, r: torch.Tensor | None, p: dict, cfg,
           window: int) -> tuple:
    """One pre-LN block on tokens ``x + r`` (B, H, W, C), ``r`` the
    previous block's MLP output (None for the first block): attention
    within windows of side ``window``, or over the grid where ``window``
    is 0. Returns ``(x', m)``, the block's output being ``x' + m``: the
    MLP's output ``m`` is left to the next block's ``norm1``, which sums
    it in its pass."""
    B, H, W, C = x.shape
    eps = cfg.ln_eps
    with span("forward.attention.window" if window
              else "forward.attention.global"):
        if window:
            side = window
            grid = (H + -H % window, W + -W % window)
        else:
            if H != W:
                raise ValueError(f"global attention takes a square grid, "
                                 f"got {H}x{W}")
            side, grid = H, None
        x, h = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], eps,
                          residual=r, pad_to=grid)
        qkv = F.linear(h, p["qkv"]["w"], p["qkv"]["b"])
        o = attention(qkv, p["rel_pos_h"], p["rel_pos_w"], cfg.vit_heads,
                      side)
        o = F.linear(o, p["proj"]["w"], p["proj"]["b"])
    x, h = layer_norm(x, p["norm2"]["w"], p["norm2"]["b"], eps,
                      residual=o[:, :H, :W])
    h = F.gelu(F.linear(h, p["fc1"]["w"], p["fc1"]["b"]))
    return x, F.linear(h, p["fc2"]["w"], p["fc2"]["b"])


def vit_forward(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Normalised images NCHW (channels_last) -> the last map, tokens
    (B, H/patch, W/patch, C). ``params`` prepared (:func:`prepare`);
    raises where its ``pos_grid`` is missing or at another grid."""
    pe = params["patch_embed"]
    t = conv_epilogue(lambda y, b: F.conv2d(y, pe["w"], b,
                                            stride=cfg.vit_patch),
                      x, pe["b"]).permute(0, 2, 3, 1)
    B, H, W, C = t.shape
    pos = params.get("pos_grid")
    if pos is None or pos.shape[1] != H * W:
        raise ValueError(f"the state's position embedding is not at the "
                         f"{H}x{W} grid: place the state with "
                         f"mask_rcnn.prepare_state")
    windows = [0 if i in cfg.vit_global_blocks else cfg.vit_window
               for i in range(len(params["blocks"]))]
    return run_blocks(t + pos.view(1, H, W, C), params["blocks"], cfg,
                      windows)


def run_blocks(x: torch.Tensor, blocks: list, cfg, windows: list
               ) -> torch.Tensor:
    """Tokens (B, H, W, C) through the pre-LN ``blocks`` in turn, block i
    attending within windows of side ``windows[i]`` (0: over the grid):
    detectron2's blocks chained, each MLP's output summed in the next
    block's ``norm1`` and the last one here."""
    r = None
    for p, window in zip(blocks, windows, strict=True):
        x, r = _block(x, r, p, cfg, window)
    return x if r is None else x + r


def simple_feature_pyramid(params: dict, x: torch.Tensor, cfg) -> list:
    """The last map's tokens (B, H, W, C) -> [P2, P3, P4, P5, P6], each
    NCHW in channels_last memory."""
    f = x.permute(0, 3, 1, 2)
    eps = cfg.ln_eps
    outs = []
    for scale, name in zip(cfg.sfp_scales, LEVELS):
        p = params[name]
        t = f
        if scale == 4.0:
            t = _deconv(ln2d(_deconv(t, p["deconv1"]), p["norm"], eps,
                             act="gelu"), p["deconv2"])
        elif scale == 2.0:
            t = _deconv(t, p["deconv1"])
        elif scale == 0.5:
            t = F.max_pool2d(t, kernel_size=2, stride=2)
        elif scale != 1.0:
            raise ValueError(f"simple feature pyramid scale {scale}")
        t = ln2d(F.conv2d(t, p["lateral"]["w"]), p["lateral_norm"], eps)
        t = ln2d(F.conv2d(t, p["output"]["w"], padding=1), p["output_norm"],
                 eps)
        outs.append(t)
    # LastLevelMaxPool: a window-1 stride-2 max is a plain subsample
    outs.append(outs[-1][:, :, ::2, ::2].contiguous(
        memory_format=torch.channels_last))
    return outs


def backbone_sfp(state: dict, x: torch.Tensor, cfg) -> list:
    """The ViT in span ``forward.backbone`` and the simple feature pyramid
    in ``forward.fpn``: preprocessed images NCHW -> P2..P6."""
    with span("forward.backbone"):
        t = vit_forward(state["backbone"], x, cfg)
    with span("forward.fpn"):
        return simple_feature_pyramid(state["fpn"], t, cfg)
