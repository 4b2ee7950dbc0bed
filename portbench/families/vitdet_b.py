"""The family of ViTDet's Mask R-CNN (``config.vitdet_b``; detectron2
``projects/ViTDet``): its seeded weights in the program's layout
(``roadsurf_tpu_torch/models/vit.py`` gives it), the class pin, the plain
reference of ``vitdet_reference.py``, the work counts that ``mfu`` and the
rooflines read (the poolers' and the NMS's bound by name from ``work.py``,
whose budgets are parity's), the attention kernel's work, the control of
``correct``, and the CPU tests' widths.

Weights: one normal draw of the seeded generator on the device, cut into
leaves (:func:`leaves`) and cast to the served dtype; 4-d tensors in
channels_last memory. Convs He (fan-in), linears 1/√fan-in, the residual
branches' last linears damped by ``RESIDUAL``, the box head's rows centred,
class logits spread by ``CLS_SPREAD``, small RPN and box-delta weights, as
``modelgen.py`` draws the R50-FPN's. Every relative-position table, the
position embedding, the qkv bias and every LN's affine are drawn away from
their initial values (detectron2 zero-inits the tables; zero tables would
let a kernel that drops the relative-position terms pass).
"""

from __future__ import annotations

import math

import torch

from portbench import modelgen
from portbench import reference as R
from portbench import vitdet_reference as V
from portbench.work import conv_flops, nms_bytes, pooler_bytes

__all__ = ["NARROW", "PIN_TILES", "attention_work", "control",
           "forward_flops", "nms_bytes", "pin_classes", "pooler_bytes",
           "run", "weights"]

PIN_TILES = 8
RESIDUAL = 0.5          # the attention's proj and the MLP's fc2, times 1/√n
POS_STD = 0.5           # position embedding (tokens are about unit-scale)
REL_STD = 0.1           # relative-position tables: q·R about 0.8 a term
QKV_BIAS_STD = 0.1
LN_STD = 0.1            # LN weight 1 + this, bias this, times a normal
CLS_SPREAD = modelgen.CLS_SPREAD
RPN_STD = modelgen.RPN_STD
BBOX_STD = modelgen.BBOX_STD
FP8_MAX = 448.0         # float8_e4m3fn's largest finite value

# the widths, and sizes, of the CPU tests' narrow runs: 128 px, an 8x8
# patch grid, windows of 3 (padded to 9), 6 blocks with global blocks 2 and
# 5, 2 heads of 16
NARROW = {"min_size_test": 128, "vit_patch": 16, "vit_dim": 32,
          "vit_heads": 2, "vit_mlp_ratio": 4.0, "vit_depth": 6,
          "vit_window": 3, "vit_global_blocks": [2, 5],
          "fpn_channels": 16, "box_fc_dim": 32, "mask_conv_dim": 16}


def _grid(st: dict) -> int:
    return st["min_size_test"] // st["vit_patch"]


def _padded(grid: int, window: int) -> int:
    return -(-grid // window) * window


def leaves(st: dict) -> list:
    """(path, shape, std, offset, centred) of every weight, in the order
    of the draw: a weight is ``offset + std · normal``, its rows made
    zero-mean where ``centred``; std 0 is a constant ``offset``."""
    out = []

    def leaf(path, shape, std, offset=0.0, centred=False):
        out.append((path, shape, std, offset, centred))

    def norm(path, c):
        leaf(path + ("w",), (c,), LN_STD, 1.0)
        leaf(path + ("b",), (c,), LN_STD)

    def conv(path, cin, cout, k, bias=True, std=None):
        leaf(path + ("w",), (cout, cin, k, k),
             math.sqrt(2.0 / (cin * k * k)) if std is None else std)
        if bias:
            leaf(path + ("b",), (cout,), 0.0)

    def linear(path, cin, cout, std, bias_std=0.0, centred=False):
        leaf(path + ("w",), (cout, cin), std, centred=centred)
        leaf(path + ("b",), (cout,), bias_std)

    D, p, nh = st["vit_dim"], st["vit_patch"], st["vit_heads"]
    hd, hidden = D // nh, int(D * st["vit_mlp_ratio"])
    G, G0 = _grid(st), st["vit_pretrain_grid"]
    bb = ("backbone",)
    conv(bb + ("patch_embed",), 3, D, p)
    leaf(bb + ("pos_embed",), (1, 1 + G0 * G0, D), POS_STD)
    for i in range(st["vit_depth"]):
        base = bb + ("blocks", i)
        side = G if i in st["vit_global_blocks"] else st["vit_window"]
        norm(base + ("norm1",), D)
        linear(base + ("qkv",), D, 3 * D, 1.0 / math.sqrt(D), QKV_BIAS_STD)
        leaf(base + ("rel_pos_h",), (2 * side - 1, hd), REL_STD)
        leaf(base + ("rel_pos_w",), (2 * side - 1, hd), REL_STD)
        linear(base + ("proj",), D, D, RESIDUAL / math.sqrt(D))
        norm(base + ("norm2",), D)
        linear(base + ("fc1",), D, hidden, math.sqrt(2.0 / D))
        linear(base + ("fc2",), hidden, D, RESIDUAL / math.sqrt(hidden))
    C = st["fpn_channels"]
    for scale, name in zip(st["sfp_scales"], ("p2", "p3", "p4", "p5")):
        base = ("fpn", name)
        cin = D
        if scale in (4.0, 2.0):
            leaf(base + ("deconv1", "w"), (D, D // 2, 2, 2),
                 1.0 / math.sqrt(D))
            leaf(base + ("deconv1", "b"), (D // 2,), 0.0)
            cin = D // 2
        if scale == 4.0:
            norm(base + ("norm",), D // 2)
            leaf(base + ("deconv2", "w"), (D // 2, D // 4, 2, 2),
                 1.0 / math.sqrt(D // 2))
            leaf(base + ("deconv2", "b"), (D // 4,), 0.0)
            cin = D // 4
        conv(base + ("lateral",), cin, C, 1, bias=False)
        norm(base + ("lateral_norm",), C)
        conv(base + ("output",), C, C, 3, bias=False)
        norm(base + ("output_norm",), C)
    A = len(st["anchor_aspect_ratios"])
    conv(("rpn", "conv"), C, C, 3)
    for i in range(2, st["rpn_num_conv"] + 1):
        conv(("rpn", f"conv{i}"), C, C, 3)
    conv(("rpn", "objectness"), C, A, 1, std=RPN_STD)
    conv(("rpn", "deltas"), C, 4 * A, 1, std=RPN_STD)
    P, fc, K = st["box_pooler_resolution"], st["box_fc_dim"], \
        st["num_classes"]
    for i in range(1, st["box_num_conv"] + 1):
        conv(("box_head", f"conv{i}"), C, C, 3, bias=False)
        norm(("box_head", f"norm{i}"), C)
    cin = C * P * P
    for i in range(1, st["box_num_fc"] + 1):
        linear(("box_head", f"fc{i}"), cin, fc, math.sqrt(2.0 / cin),
               centred=True)
        cin = fc
    linear(("box_head", "cls"), fc, K + 1, CLS_SPREAD / math.sqrt(fc),
           centred=True)
    linear(("box_head", "bbox"), fc, 4 * K, BBOX_STD)
    M, cin = st["mask_conv_dim"], C
    for i in range(1, st["mask_num_conv"] + 1):
        conv(("mask_head", f"conv{i}"), cin, M, 3, bias=False)
        norm(("mask_head", f"norm{i}"), M)
        cin = M
    leaf(("mask_head", "deconv", "w"), (cin, M, 2, 2),
         math.sqrt(2.0 / (4 * cin)))
    leaf(("mask_head", "deconv", "b"), (M,), 0.0)
    conv(("mask_head", "predictor"), M, K, 1)
    return out


def weights(st: dict, g: torch.Generator, device, dtype) -> dict:
    """The state: every leaf of :func:`leaves`, cut from one normal draw
    of the generator on ``device``, in ``dtype``, 4-d tensors in
    channels_last memory."""
    spec = leaves(st)
    total = sum(math.prod(shape) for _, shape, std, _, _ in spec if std)
    flat = torch.randn(total, generator=g, device=device)
    state: dict = {}
    off = 0
    for path, shape, std, offset, centred in spec:
        n = math.prod(shape)
        if std:
            t = flat[off:off + n].view(shape) * std + offset
            off += n
            if centred:
                t = t - t.mean(dim=1, keepdim=True)
        else:
            t = torch.full(shape, float(offset), device=device)
        t = t.to(dtype)
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        modelgen._put(state, path, t)
    return state


@torch.no_grad()
def pin_classes(state: dict, st: dict, tiles_u8, device):
    """Each class's bias set so that ``modelgen.PASS_SHARE`` of its
    (proposal, class) candidates on ``tiles_u8`` pass the score threshold,
    by bisection on this family's reference logits (as
    ``modelgen.pin_classes`` does for the R50-FPN)."""
    x = torch.from_numpy(tiles_u8).to(device)
    with R.no_tf32():
        feats = V.backbone_sfp(state, R.preprocess(x, st), st)
        props, _, valid = R.proposals(*V.rpn(state, feats, st), R.anchors(
            st["min_size_test"], st, device), st)
        logits = torch.cat([V.box_head(state, R.roi_align(
            [f[j] for f in feats[:4]], props[j][valid[j]],
            st["box_pooler_resolution"], st), st)[0]
            for j in range(x.shape[0])])
    b = state["box_head"]["cls"]["b"]
    for c in range(st["num_classes"]):
        lo, hi = -40.0, 40.0
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            z = logits.clone()
            z[:, c] += mid
            share = (z.softmax(-1)[:, c] >= st["score_thresh_test"]
                     ).float().mean().item()
            lo, hi = (lo, mid) if share > modelgen.PASS_SHARE else (mid, hi)
        b[c] = b[c] + 0.5 * (lo + hi)


def run(W: dict, images_u8, st: dict, given=None, block: int = 8) -> list:
    """The plain reference (``vitdet_reference.run``) on the weights as
    drawn: under :func:`control` the state carries them as
    ``"reference"``."""
    return V.run(W.get("reference", W), images_u8, st, given, block)


def _blocks(st: dict):
    """(padded tokens, window side, windows) of each block at the
    configuration's input."""
    G = _grid(st)
    for i in range(st["vit_depth"]):
        if i in st["vit_global_blocks"]:
            yield G * G, G, 1
        else:
            w = st["vit_window"]
            Gp = _padded(G, w)
            yield Gp * Gp, w, (Gp // w) ** 2


def level_sizes(st: dict) -> list:
    """P2..P6 side lengths of the simple feature pyramid."""
    G = _grid(st)
    p5 = G // 2
    return [4 * G, 2 * G, G, p5, (p5 + 1) // 2]


def forward_flops(st: dict, tile_px: int) -> int:
    """FLOPs of one tile's convolutions and matrix products in the plain
    reference, 2 a multiply-add, at the configuration's budgets (the rules
    of ``work.py``): the resize, the patch embedding, each block's qkv and
    proj (on the padded tokens of a windowed block, as detectron2 runs
    them), its attention's two products and the two relative-position
    products, its MLP, the simple feature pyramid, the RPN head on every
    level, the box head on ``rpn_post_nms_topk_test`` proposals and the
    mask head on ``detections_per_image`` boxes."""
    S = st["min_size_test"]
    f = 0
    if S != tile_px:
        f += 2 * 3 * S * tile_px * (tile_px + S)
    D, p, nh = st["vit_dim"], st["vit_patch"], st["vit_heads"]
    hd, hidden = D // nh, int(D * st["vit_mlp_ratio"])
    G = _grid(st)
    f += conv_flops(3, D, p, G, G)
    for tokens, side, windows in _blocks(st):
        N = side * side
        f += 2 * tokens * D * 3 * D + 2 * tokens * D * D
        f += windows * nh * (4 * N * N * hd + 4 * N * side * hd)
        f += 2 * 2 * G * G * D * hidden
    C = st["fpn_channels"]
    for scale, s in zip(st["sfp_scales"], level_sizes(st)):
        cin = D
        if scale in (4.0, 2.0):
            f += 2 * D * (D // 2) * 4 * G * G
            cin = D // 2
        if scale == 4.0:
            f += 2 * (D // 2) * (D // 4) * 4 * (2 * G) ** 2
            cin = D // 4
        f += conv_flops(cin, C, 1, s, s) + conv_flops(C, C, 3, s, s)
    A = len(st["anchor_aspect_ratios"])
    for s in level_sizes(st):
        f += st["rpn_num_conv"] * conv_flops(C, C, 3, s, s) \
            + conv_flops(C, A, 1, s, s) + conv_flops(C, 4 * A, 1, s, s)
    R_, P = st["rpn_post_nms_topk_test"], st["box_pooler_resolution"]
    fc, K = st["box_fc_dim"], st["num_classes"]
    f += R_ * st["box_num_conv"] * conv_flops(C, C, 3, P, P)
    f += 2 * R_ * (C * P * P * fc + (st["box_num_fc"] - 1) * fc * fc
                   + fc * (K + 1) + fc * 4 * K)
    D_, Pm, M = st["detections_per_image"], st["mask_pooler_resolution"], \
        st["mask_conv_dim"]
    cin = C
    for _ in range(st["mask_num_conv"]):
        f += D_ * conv_flops(cin, M, 3, Pm, Pm)
        cin = M
    f += D_ * 2 * cin * M * 4 * Pm * Pm
    f += D_ * conv_flops(M, K, 1, 2 * Pm, 2 * Pm)
    return f


def attention_work(st: dict, tile_px: int) -> tuple:
    """(FLOPs, bytes) of one tile's launches of the attention kernel (K7):
    4 · N² · head_dim FLOPs a head and window (the two products; the
    softmax and the relative-position adds are not counted), and q, k, v,
    the output (N · head_dim each) and the two tables (N · side each) read
    or written once, in bf16."""
    D, nh = st["vit_dim"], st["vit_heads"]
    hd = D // nh
    flops = nbytes = 0
    for _, side, windows in _blocks(st):
        N = side * side
        flops += windows * nh * 4 * N * N * hd
        nbytes += windows * nh * (4 * N * hd + 2 * N * side) * 2
    return flops, nbytes


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8_e4m3fn at a per-tensor scale (its
    largest magnitude to 448) and back, in its dtype."""
    s = t.float().abs().max().clamp(min=1e-12) / FP8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def _rounded(tree):
    if isinstance(tree, dict):
        return {k: _rounded(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rounded(v) for v in tree]
    out = _fp8(tree)
    if tree.dim() == 4:
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def control(cfg, state: dict, pool, dev):
    """The control of ``correct`` (``harness.run_cell(...,
    prepare=control)``): the program on every weight rounded through
    float8_e4m3fn, the card's precision below bf16, at a per-tensor scale.
    The reference keeps the weights as drawn: ``run`` reads them from the
    state's ``"reference"`` entry, which the program does not read."""
    return cfg, dict(_rounded(state), reference=state)
