"""The plain reference that decides ``correct``: Mask R-CNN R50-FPN
inference in float32 with TF32 off, in plain PyTorch, on the weights and
tiles the harness made.

A frozen, adapted copy of ``tests/torch_ref_model.py`` at commit
3882033a3117a5eeb7cc5982f7f3c4eaa452742c (detectron2 semantics: folded
FrozenBN ResNet-50, FPN with LastLevelMaxPool, StandardRPNHead, ROIAlignV2
transcribed sample by sample, greedy NMS from its definition,
FastRCNNConvFCHead and MaskRCNNConvUpsampleHead). Adapted so that it:

* reads the weights in the layout the harness gives both sides (OIHW
  convs, (out, in) linears, the (in, out, kh, kw) deconv; fc1's input in
  (p, q, c) order) and upcasts each to float32 where it is used;
* runs a block of tiles at once on their device, and every tile of a
  block through the same fixed budgets as the configuration states:
  the bilinear resize to ``min_size_test`` (half-pixel centres, edge
  clamp), per-level top-k and per-level NMS with a global top-k (exactly
  detectron2's level-aware NMS), the overlap test ``inter > t·union``,
  ties to the lower index, the 0.05 score threshold, class-aware NMS and
  the top ``detections_per_image``;
* follows the fast profile where its configuration says so: fixed s×s
  sampling, single-sweep NMS (a box is kept iff no valid box before it in
  priority overlaps it) and the local-max gate on the RPN's objectness
  (an anchor with an overlapping same-aspect neighbour one stride away
  that ranks before it is dropped before the top-k);
* packs masks as the bits the program sends (logit >= 0, eight cells a
  byte, little bit order), and can pool the mask head on boxes it is
  given, the program's, so that each mask is judged on its own box.

It imports nothing of ``roadsurf_tpu_torch``, ``roadsurf_tpu`` or JAX.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

SCALE_CLAMP = math.log(1000.0 / 16.0)
STRIDES = (4, 8, 16, 32, 64)


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _conv(x, p, stride=1, relu=False):
    w = p["w"].float()
    y = F.conv2d(x, w, p["b"].float(), stride=stride,
                 padding=w.shape[-1] // 2)
    return F.relu(y) if relu else y


def _linear(x, p):
    return F.linear(x, p["w"].float(), p["b"].float())


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear weights, half-pixel centres, edge clamp."""
    m = np.zeros((dst, src), np.float64)
    for i in range(dst):
        c = (i + 0.5) * src / dst - 0.5
        f = math.floor(c)
        w = c - f
        m[i, min(max(f, 0), src - 1)] += 1.0 - w
        m[i, min(max(f + 1, 0), src - 1)] += w
    return m.astype(np.float32)


def preprocess(images_u8: torch.Tensor, st: dict) -> torch.Tensor:
    """(N, T, T, 3) uint8 -> normalised float32 (N, 3, S, S)."""
    x = images_u8.float().permute(0, 3, 1, 2)
    S, T = st["min_size_test"], images_u8.shape[1]
    if S != T:
        m = torch.from_numpy(resize_matrix(T, S)).to(x.device)
        x = torch.einsum("ih,nchw,jw->ncij", m, x, m)
    mean = torch.tensor(st["pixel_mean"], device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(st["pixel_std"], device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def backbone_fpn(W: dict, x: torch.Tensor) -> list:
    """Normalised NCHW images -> [P2..P6] NCHW float32."""
    bb = W["backbone"]
    x = _conv(x, bb["stem"], 2, relu=True)
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    feats = []
    for si, stage in enumerate(("res2", "res3", "res4", "res5")):
        for bi, p in enumerate(bb[stage]):
            s = 2 if (si > 0 and bi == 0) else 1
            out = _conv(x, p["conv1"], s, relu=True)
            out = _conv(out, p["conv2"], relu=True)
            out = _conv(out, p["conv3"])
            sc = _conv(x, p["shortcut"], s) if "shortcut" in p else x
            x = F.relu(out + sc)
        feats.append(x)
    fpn = W["fpn"]
    lat = [_conv(f, fpn[f"lateral{i + 2}"]) for i, f in enumerate(feats)]
    td = [None] * 3 + [lat[3]]
    for i in (2, 1, 0):
        td[i] = lat[i] + F.interpolate(td[i + 1], scale_factor=2,
                                       mode="nearest")
    outs = [_conv(td[i], fpn[f"output{i + 2}"]) for i in range(4)]
    outs.append(F.max_pool2d(outs[3], 1, stride=2))
    return outs


def rpn(W: dict, feats: list) -> tuple[list, list]:
    """Per level: objectness (N, H·W·A), deltas (N, H·W·A, 4), rows in
    (y, x, a) order."""
    p = W["rpn"]
    logits, deltas = [], []
    for f in feats:
        t = _conv(f, p["conv"], relu=True)
        o, d = _conv(t, p["objectness"]), _conv(t, p["deltas"])
        n = o.shape[0]
        logits.append(o.permute(0, 2, 3, 1).reshape(n, -1))
        deltas.append(d.permute(0, 2, 3, 1).reshape(n, -1, 4))
    return logits, deltas


def anchors(S: int, st: dict, device) -> list:
    out = []
    for stride, size in zip(STRIDES, st["anchor_sizes"]):
        cell = []
        for a in st["anchor_aspect_ratios"]:
            w = math.sqrt(float(size) ** 2 / a)
            h = a * w
            cell.append([-w / 2, -h / 2, w / 2, h / 2])
        cell = torch.tensor(cell, dtype=torch.float32)
        f = -(-S // stride)
        xs = (torch.arange(f, dtype=torch.float32) + st["anchor_offset"]) \
            * stride
        sy, sx = torch.meshgrid(xs, xs, indexing="ij")
        shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
        out.append((shifts + cell[None]).reshape(-1, 4).to(device))
    return out


def decode(deltas, boxes, weights):
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dw = torch.clamp(deltas[..., 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=SCALE_CLAMP)
    px, py = deltas[..., 0] / wx * w + cx, deltas[..., 1] / wy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2],
                       dim=-1)


def clip(boxes, S):
    return boxes.clamp(0.0, float(S))


def overlaps(boxes: torch.Tensor, t: float) -> torch.Tensor:
    """(..., N, N) bool: inter > t·union."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) \
        * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter > t * union


def nms_in_order(over: torch.Tensor, valid: torch.Tensor,
                 sweep: bool) -> torch.Tensor:
    """Keep masks (G, N) of G problems whose N candidates are in priority
    order; ``over`` (G, N, N). Greedy: a candidate is kept iff no KEPT
    candidate before it overlaps it; sweep: iff no VALID one does."""
    n = valid.shape[-1]
    before = torch.ones(n, n, dtype=torch.bool,
                        device=valid.device).triu(1)        # i before j
    if sweep:
        hit = (over & before & valid[..., :, None]).any(dim=-2)
        return valid & ~hit
    keep = valid.clone()
    for i in range(n - 1):
        keep[:, i + 1:] &= ~(over[:, i, i + 1:] & keep[:, i:i + 1])
    return keep


def local_max_gate(lg: torch.Tensor, st: dict, stride: int,
                   size: float) -> torch.Tensor:
    """The fast profile's pre-gate: (N, H·W·A) -> a bool mask of the
    anchors it drops. Along an axis where same-aspect anchors one stride
    apart overlap above the RPN's NMS threshold, an anchor goes when its
    neighbour before it (up, left) scores at least as high or the one
    after it (down, right) scores higher."""
    A = len(st["anchor_aspect_ratios"])
    n = lg.shape[1]
    side = int(round(math.sqrt(n // A)))
    drop = torch.zeros_like(lg, dtype=torch.bool)
    if side * side * A != n:
        return drop
    x = lg.view(-1, side, side, A)
    d = drop.view(-1, side, side, A)
    t = st["rpn_nms_thresh"]
    for a, ratio in enumerate(st["anchor_aspect_ratios"]):
        w = math.sqrt(float(size) ** 2 / ratio)
        h = ratio * w
        v = x[..., a]
        if (w - stride) / (w + stride) > t:
            d[:, :, 1:, a] |= v[:, :, :-1] >= v[:, :, 1:]      # left
            d[:, :, :-1, a] |= v[:, :, 1:] > v[:, :, :-1]      # right
        if (h - stride) / (h + stride) > t:
            d[:, 1:, :, a] |= v[:, :-1, :] >= v[:, 1:, :]      # up
            d[:, :-1, :, a] |= v[:, 1:, :] > v[:, :-1, :]      # down
    return drop


def proposals(logits, deltas, anchors_l, st: dict):
    """-> boxes (N, K, 4), scores (N, K), valid (N, K), K = the
    post-NMS budget, in priority order."""
    S = st["min_size_test"]
    pre, post = st["rpn_pre_nms_topk_test"], st["rpn_post_nms_topk_test"]
    sweep = st["fast_nms"]
    gate = sweep and st["rpn_local_max_gate"]
    all_b, all_s = [], []
    for l, (lg, dl, an) in enumerate(zip(logits, deltas, anchors_l)):
        lg = lg.float()
        ok = ~local_max_gate(lg, st, STRIDES[l], st["anchor_sizes"][l]) \
            if gate else torch.ones_like(lg, dtype=torch.bool)
        key = torch.where(ok, lg, torch.full_like(lg, -math.inf))
        k = min(pre, lg.shape[1])
        order = torch.sort(key, dim=1, descending=True, stable=True
                           ).indices[:, :k]
        sc = torch.gather(lg, 1, order)
        valid = torch.gather(ok, 1, order)
        b = clip(decode(torch.gather(dl.float(), 1,
                                     order[..., None].expand(-1, -1, 4)),
                        an[order], (1.0, 1.0, 1.0, 1.0)), S)
        valid &= (b[..., 2] > b[..., 0]) & (b[..., 3] > b[..., 1])
        keep = nms_in_order(overlaps(b, st["rpn_nms_thresh"]), valid, sweep)
        keep &= torch.cumsum(keep, dim=1) <= post
        all_b.append(b)
        all_s.append(torch.where(keep, sc, torch.full_like(sc, -math.inf)))
    b, s = torch.cat(all_b, dim=1), torch.cat(all_s, dim=1)
    order = torch.sort(s, dim=1, descending=True, stable=True
                       ).indices[:, :post]
    s = torch.gather(s, 1, order)
    b = torch.gather(b, 1, order[..., None].expand(-1, -1, 4))
    return b, s, s > -math.inf


def _axis_weights(lo, hi, dim: int, stride: int, P: int,
                  sampling: int) -> torch.Tensor:
    """(R, P, dim) ROIAlignV2 weights along one axis, sample by sample:
    roi start lo/stride − 0.5, P bins, n samples a bin (``sampling``, or
    ceil(bin cells) at least 1 when 0) at the bins' (i + 0.5)/n points; a
    sample outside [−1, dim] counts 0, else it is clamped to 0 from below
    and its two taps share 1 (both on the last cell past dim − 1); each
    weighs 1/n."""
    start = lo / stride - 0.5
    binw = (hi / stride - 0.5 - start) / P                      # (R,)
    if sampling > 0:
        n = torch.full_like(binw, float(sampling))
    else:
        n = torch.ceil(binw).clamp(min=1.0)
    R = lo.shape[0]
    w = torch.zeros(R, P, dim, device=lo.device)
    p = torch.arange(P, device=lo.device, dtype=torch.float32)
    for i in range(int(n.max().item()) if R else 0):
        c = start[:, None] + p[None] * binw[:, None] \
            + (i + 0.5) * (binw / n)[:, None]                 # (R, P)
        use = ((c >= -1.0) & (c <= float(dim)) & (i < n)[:, None]).float() \
            / n[:, None]
        y = c.clamp(min=0.0)
        low = torch.floor(y)
        last = low >= dim - 1
        low = torch.where(last, torch.full_like(low, dim - 1), low)
        frac = torch.where(last, torch.zeros_like(y), y - low)
        high = torch.where(last, low, low + 1)
        w.scatter_add_(2, low.long()[..., None], ((1 - frac) * use)[..., None])
        w.scatter_add_(2, high.long()[..., None], (frac * use)[..., None])
    return w


def roi_align(levels: list, boxes: torch.Tensor, P: int, st: dict,
              chunk: int = 64) -> torch.Tensor:
    """One tile's multilevel ROIAlignV2: ``levels`` [P2..P5] each (C, H,
    W), ``boxes`` (R, 4) in input coordinates -> (R, C, P, P). Each box
    pools from level floor(4 + log2(sqrt(area)/224)), clipped to P2 and
    to the highest level a box of this image can reach."""
    S = st["min_size_test"]
    top = math.floor(st["canonical_level"]
                     + math.log2(S / st["canonical_box_size"] + 1e-8))
    top = max(2, min(5, top))
    w = (boxes[:, 2] - boxes[:, 0]).clamp(min=0)
    h = (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
    lvl = torch.floor(st["canonical_level"] + torch.log2(
        torch.sqrt(w * h) / st["canonical_box_size"] + 1e-8))
    lvl = lvl.clamp(2, top).long() - 2
    C = levels[0].shape[0]
    out = boxes.new_zeros(boxes.shape[0], C, P, P)
    for l in range(top - 1):
        sel = (lvl == l).nonzero(as_tuple=True)[0]
        f = levels[l]
        stride = STRIDES[l]
        for i in range(0, len(sel), chunk):
            s = sel[i:i + chunk]
            b = boxes[s]
            wy = _axis_weights(b[:, 1], b[:, 3], f.shape[1], stride, P,
                               st["pooler_sampling_ratio"])
            wx = _axis_weights(b[:, 0], b[:, 2], f.shape[2], stride, P,
                               st["pooler_sampling_ratio"])
            t = torch.einsum("rph,chw->rpcw", wy, f)
            out[s] = torch.einsum("rpcw,rqw->rcpq", t, wx)
    return out


def box_head(W: dict, pooled: torch.Tensor):
    """(R, C, P, P) -> class logits (R, K+1), deltas (R, 4K)."""
    p = W["box_head"]
    x = pooled.permute(0, 2, 3, 1).reshape(pooled.shape[0], -1)
    x = F.relu(_linear(x, p["fc1"]))
    x = F.relu(_linear(x, p["fc2"]))
    return _linear(x, p["cls"]), _linear(x, p["bbox"])


def detections(logits, deltas, props, st: dict):
    """One tile's post-processing -> boxes (D', 4) in input coordinates,
    scores (D',), classes (D',), D' <= detections_per_image."""
    K = st["num_classes"]
    R = props.shape[0]
    probs = logits.softmax(-1)[:, :K]
    boxes = clip(decode(deltas.view(R, K, 4), props[:, None],
                        st["box_bbox_weights"]), st["min_size_test"])
    scores = probs.reshape(-1)
    boxes = boxes.reshape(-1, 4)
    classes = torch.arange(K, device=props.device).repeat(R)
    ok = scores >= st["score_thresh_test"]
    idx = ok.nonzero(as_tuple=True)[0]
    order = idx[torch.sort(scores[idx], descending=True, stable=True
                           ).indices]
    b, s, c = boxes[order], scores[order], classes[order]
    over = overlaps(b, st["nms_thresh_test"]) & (c[:, None] == c[None, :])
    keep = nms_in_order(over[None], torch.ones_like(s, dtype=torch.bool
                                                    )[None],
                        st["fast_nms"])[0]
    kept = keep.nonzero(as_tuple=True)[0][:st["detections_per_image"]]
    return b[kept], s[kept], c[kept]


def mask_logits(W: dict, levels: list, boxes, classes, st: dict):
    """The mask head on ``boxes`` (input coordinates) -> (D, 2P, 2P)
    logits of each box's class."""
    if boxes.shape[0] == 0:
        P2 = 2 * st["mask_pooler_resolution"]
        return boxes.new_zeros(0, P2, P2)
    x = roi_align(levels, boxes, st["mask_pooler_resolution"], st)
    p = W["mask_head"]
    for i in range(st["mask_num_conv"]):
        x = _conv(x, p[f"conv{i + 1}"], relu=True)
    d = p["deconv"]
    x = F.relu(F.conv_transpose2d(x, d["w"].float(), d["b"].float(),
                                  stride=2))
    x = _conv(x, p["predictor"])
    return x[torch.arange(len(classes), device=x.device), classes.long()]


def pack_bits(logits: torch.Tensor) -> torch.Tensor:
    """(D, H, W) logits -> (D, H·W/8) uint8: cell i is bit i % 8 of byte
    i // 8, set where the logit is >= 0."""
    cells = logits.shape[1] * logits.shape[2]
    bits = (logits >= 0).reshape(logits.shape[0], cells // 8, 8).long()
    return (bits << torch.arange(8, device=logits.device)).sum(-1).to(
        torch.uint8)


@torch.no_grad()
def run(W: dict, images_u8: torch.Tensor, st: dict, given=None,
        block: int = 8) -> list:
    """Every tile of ``images_u8`` (N, T, T, 3) through the reference ->
    one dict a tile: ``boxes`` (D', 4) in tile coordinates, ``scores``,
    ``classes``, ``mask_logits`` (D', 2P, 2P); with ``given`` (a list of
    (boxes (D, 4) in tile coordinates, classes (D,)) a tile), also
    ``given_mask_logits``: the mask head on those boxes."""
    S, T = st["min_size_test"], images_u8.shape[1]
    an = anchors(S, st, images_u8.device)
    out = []
    with no_tf32():
        for i in range(0, images_u8.shape[0], block):
            x = preprocess(images_u8[i:i + block], st)
            feats = backbone_fpn(W, x)
            props, _, pvalid = proposals(*rpn(W, feats), an, st)
            for j in range(x.shape[0]):
                levels = [f[j] for f in feats[:4]]
                pr = props[j][pvalid[j]]
                lg, dl = box_head(W, roi_align(
                    levels, pr, st["box_pooler_resolution"], st))
                b, s, c = detections(lg, dl, pr, st)
                d = {"boxes": b * (T / S), "scores": s, "classes": c,
                     "mask_logits": mask_logits(W, levels, b, c, st)}
                if given is not None:
                    gb, gc = given[i + j]
                    d["given_mask_logits"] = mask_logits(
                        W, levels, gb * (S / T), gc, st)
                out.append(d)
    return out
