"""The plain reference of the ViTDet-B family (``families/vitdet_b.py``):
ViTDet's Mask R-CNN inference in float32 with TF32 off, in plain PyTorch,
on the weights and tiles the harness made.

It follows detectron2's code (``modeling/backbone/vit.py``: ``ViT``,
``Block``, ``Attention``, ``SimpleFeaturePyramid``; ``modeling/backbone/
utils.py``: ``window_partition``, ``window_unpartition``, ``get_abs_pos``,
``get_rel_pos``, ``add_decomposed_rel_pos``; ``layers.LayerNorm``; the
two-conv ``StandardRPNHead``, the 4conv1fc ``FastRCNNConvFCHead`` and the
``MaskRCNNConvUpsampleHead`` with ``conv_norm="LN"``) as
``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py`` sets it up:
windows zero-padded after ``norm1`` and their padded tokens kept as keys,
the relative-position terms from the unscaled ``q``, the position
embedding resized on every forward, attention from materialised scores (a
chunk of images or windows at a time, the same numbers). Proposals,
ROIAlignV2, the detections and the mask bits are ``reference.py``'s, shared
with the R50-FPN family (detectron2's semantics at the configuration's
budgets).

Departures from the published model, none of which changes an operation:

* 2 classes, the repository's task (80 in COCO);
* no square pad: the 256 px tiles are resized (bilinear, as
  ``reference.preprocess`` resizes them) to 1024 x 1024, which is the
  padded size already;
* no drop-path: it is the identity at inference;
* the pixel mean and std are applied to the tiles' channels in their
  order (ViTDet's are for RGB);
* the box head's FC reads its input in (p, q, c) order, the layout the
  harness gives both sides (detectron2 flattens (c, p, q)).

It imports nothing of ``roadsurf_tpu_torch``, ``roadsurf_tpu`` or JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import reference as R

# a chunk's attention scores, at most (float32 values)
SCORES_CHUNK = 1 << 28


def _linear(x, p):
    b = p.get("b")
    return F.linear(x, p["w"].float(), None if b is None else b.float())


def _conv(x, p, stride=1, padding=None):
    w = p["w"].float()
    b = p.get("b")
    return F.conv2d(x, w, None if b is None else b.float(), stride=stride,
                    padding=w.shape[-1] // 2 if padding is None else padding)


def layer_norm(x, p, eps):
    """``nn.LayerNorm`` over the last dim."""
    return F.layer_norm(x, (x.shape[-1],), p["w"].float(), p["b"].float(),
                        eps)


def channel_norm(x, p, eps):
    """detectron2's ``layers.LayerNorm``: over the channels of NCHW."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return p["w"].float()[:, None, None] * x + p["b"].float()[:, None, None]


def get_abs_pos(abs_pos, hw):
    """detectron2's ``get_abs_pos`` with a class token."""
    h, w = hw
    abs_pos = abs_pos[:, 1:]
    xy_num = abs_pos.shape[1]
    size = int(math.sqrt(xy_num))
    assert size * size == xy_num
    if size != h or size != w:
        new_abs_pos = F.interpolate(
            abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
            size=(h, w), mode="bicubic", align_corners=False)
        return new_abs_pos.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


def get_rel_pos(q_size, k_size, rel_pos):
    """detectron2's ``get_rel_pos``."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos_resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode="linear")
        rel_pos_resized = rel_pos_resized.reshape(-1, max_rel_dist) \
            .permute(1, 0)
    else:
        rel_pos_resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) \
        + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos_resized[relative_coords.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    """detectron2's ``add_decomposed_rel_pos``."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B, q_h * q_w, k_h * k_w)
    return attn


def window_partition(x, window_size):
    """detectron2's ``window_partition``: zero padding to a multiple."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size,
               window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous() \
        .view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    """detectron2's ``window_unpartition``."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def attention(p, x, num_heads):
    """detectron2's ``Attention.forward`` (qkv bias, relative position), a
    chunk of the batch (images or windows) at a time."""
    B, H, W, _ = x.shape
    step = max(1, SCORES_CHUNK // (num_heads * (H * W) ** 2))
    return torch.cat([_attention(p, x[i:i + step], num_heads)
                      for i in range(0, B, step)])


def _attention(p, x, num_heads):
    B, H, W, _ = x.shape
    qkv = _linear(x, p["qkv"]).reshape(B, H * W, 3, num_heads, -1) \
        .permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * num_heads, H * W, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = add_decomposed_rel_pos(attn, q, p["rel_pos_h"].float(),
                                  p["rel_pos_w"].float(), (H, W), (H, W))
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(B, num_heads, H, W, -1).permute(0, 2, 3, 1, 4) \
        .reshape(B, H, W, -1)
    return _linear(x, p["proj"])


def block(p, x, st, window_size):
    """detectron2's ``Block.forward`` at inference."""
    eps = st["ln_eps"]
    shortcut = x
    x = layer_norm(x, p["norm1"], eps)
    if window_size > 0:
        H, W = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window_size)
    x = attention(p, x, st["vit_heads"])
    if window_size > 0:
        x = window_unpartition(x, window_size, pad_hw, (H, W))
    x = shortcut + x
    h = F.gelu(_linear(layer_norm(x, p["norm2"], eps), p["fc1"]))
    return x + _linear(h, p["fc2"])


def vit(W, x, st):
    """``ViT.forward``: normalised NCHW images -> the last map NCHW."""
    bb = W["backbone"]
    x = _conv(x, bb["patch_embed"], stride=st["vit_patch"], padding=0) \
        .permute(0, 2, 3, 1)
    x = x + get_abs_pos(bb["pos_embed"].float(), (x.shape[1], x.shape[2]))
    for i, p in enumerate(bb["blocks"]):
        x = block(p, x, st, 0 if i in st["vit_global_blocks"]
                  else st["vit_window"])
    return x.permute(0, 3, 1, 2)


def _deconv(x, p):
    return F.conv_transpose2d(x, p["w"].float(), p["b"].float(), stride=2)


def simple_feature_pyramid(W, features, st):
    """``SimpleFeaturePyramid.forward`` with ``LastLevelMaxPool``:
    [P2..P6] NCHW."""
    eps = st["ln_eps"]
    results = []
    for scale, name in zip(st["sfp_scales"], ("p2", "p3", "p4", "p5")):
        p = W["fpn"][name]
        x = features
        if scale == 4.0:
            x = _deconv(x, p["deconv1"])
            x = F.gelu(channel_norm(x, p["norm"], eps))
            x = _deconv(x, p["deconv2"])
        elif scale == 2.0:
            x = _deconv(x, p["deconv1"])
        elif scale == 0.5:
            x = F.max_pool2d(x, kernel_size=2, stride=2)
        x = channel_norm(_conv(x, p["lateral"]), p["lateral_norm"], eps)
        x = channel_norm(_conv(x, p["output"]), p["output_norm"], eps)
        results.append(x)
    results.append(F.max_pool2d(results[-1], kernel_size=1, stride=2))
    return results


def backbone_sfp(W, x, st):
    return simple_feature_pyramid(W, vit(W, x, st), st)


def rpn(W, feats, st):
    """``StandardRPNHead`` with ``rpn_num_conv`` convs: per level
    objectness (N, H·W·A), deltas (N, H·W·A, 4), rows in (y, x, a)
    order."""
    p = W["rpn"]
    logits, deltas = [], []
    for f in feats:
        t = F.relu(_conv(f, p["conv"]))
        for i in range(2, st["rpn_num_conv"] + 1):
            t = F.relu(_conv(t, p[f"conv{i}"]))
        o, d = _conv(t, p["objectness"]), _conv(t, p["deltas"])
        n = o.shape[0]
        logits.append(o.permute(0, 2, 3, 1).reshape(n, -1))
        deltas.append(d.permute(0, 2, 3, 1).reshape(n, -1, 4))
    return logits, deltas


def _head_convs(p, x, n, eps):
    """A head's ``n`` convs without bias, each with its channel LN and
    ReLU."""
    for i in range(1, n + 1):
        x = F.relu(channel_norm(_conv(x, p[f"conv{i}"]), p[f"norm{i}"], eps))
    return x


def box_head(W, pooled, st):
    """``FastRCNNConvFCHead`` (4conv1fc, LN) and the predictors: (R, C, P,
    P) -> class logits (R, K+1), deltas (R, 4K)."""
    p = W["box_head"]
    x = _head_convs(p, pooled, st["box_num_conv"], st["ln_eps"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for i in range(1, st["box_num_fc"] + 1):
        x = F.relu(_linear(x, p[f"fc{i}"]))
    return _linear(x, p["cls"]), _linear(x, p["bbox"])


def mask_logits(W, levels, boxes, classes, st):
    """``MaskRCNNConvUpsampleHead`` (LN) on ``boxes`` (input coordinates)
    -> (D, 2P, 2P) logits of each box's class."""
    if boxes.shape[0] == 0:
        P2 = 2 * st["mask_pooler_resolution"]
        return boxes.new_zeros(0, P2, P2)
    p = W["mask_head"]
    x = R.roi_align(levels, boxes, st["mask_pooler_resolution"], st)
    x = _head_convs(p, x, st["mask_num_conv"], st["ln_eps"])
    x = F.relu(_deconv(x, p["deconv"]))
    x = _conv(x, p["predictor"])
    return x[torch.arange(len(classes), device=x.device), classes.long()]


@torch.no_grad()
def run(W: dict, images_u8: torch.Tensor, st: dict, given=None,
        block: int = 8) -> list:
    """Every tile of ``images_u8`` (N, T, T, 3) through the reference ->
    one dict a tile, as ``reference.run`` returns it (``given``: the
    program's boxes and classes a tile, for ``given_mask_logits``)."""
    S, T = st["min_size_test"], images_u8.shape[1]
    an = R.anchors(S, st, images_u8.device)
    out = []
    with R.no_tf32():
        for i in range(0, images_u8.shape[0], block):
            x = R.preprocess(images_u8[i:i + block], st)
            feats = backbone_sfp(W, x, st)
            props, _, pvalid = R.proposals(*rpn(W, feats, st), an, st)
            for j in range(x.shape[0]):
                levels = [f[j] for f in feats[:4]]
                pr = props[j][pvalid[j]]
                lg, dl = box_head(W, R.roi_align(
                    levels, pr, st["box_pooler_resolution"], st), st)
                b, s, c = R.detections(lg, dl, pr, st)
                d = {"boxes": b * (T / S), "scores": s, "classes": c,
                     "mask_logits": mask_logits(W, levels, b, c, st)}
                if given is not None:
                    gb, gc = given[i + j]
                    d["given_mask_logits"] = mask_logits(
                        W, levels, gb * (S / T), gc, st)
                out.append(d)
    return out
