"""The work a tile of the R50-FPN family needs (``families/r50_fpn.py``),
counted from the configuration's shapes, and the card's published peaks,
which every family shares: what ``mfu`` and the kernel rooflines divide
by. Nothing here reads the program.

Peaks: frozen copies of ``roadsurf_tpu_torch/tools/bench_common.py``'s
``BF16_PEAK`` and ``chip_smoke.py``'s ``HBM_BYTES_PER_S`` at commit
3882033a3117a5eeb7cc5982f7f3c4eaa452742c: NVIDIA's data sheet for the H100
SXM, dense, at its 700 W power limit.

Rules:

* ``forward_flops``: the multiply-adds of the plain reference's
  convolutions and matrix products for one tile, 2 FLOPs each, at the
  configuration's budgets (``rpn_post_nms_topk_test`` proposals through
  the box head, ``detections_per_image`` boxes through the mask head: the
  shapes the program runs), the resize matmuls included. Pooling, NMS,
  softmax and elementwise work are not counted;
* ``pooler_bytes``: a lower bound on the bytes both poolers of one tile
  must move: each box read once (4 float32) and each pooled value written
  once in the served dtype. The feature cells a box's samples touch depend
  on the boxes, which a count from shapes cannot know, so none is counted;
* ``nms_bytes``: the bytes the exact NMS kernel of one tile must move:
  each candidate's box (4 float32) and score (float32) read once and its
  keep flag (1 byte) written once, over the RPN's per-level candidates
  and the box head's (proposal, class) candidates. Its operations depend
  on which boxes survive and are not counted.
"""

from __future__ import annotations

BF16_PEAK = 989e12              # FLOP/s, H100 SXM dense bf16
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
PEAKS = "H100 SXM dense peaks (NVIDIA data sheet) at 700 W"
STRIDES = (4, 8, 16, 32, 64)
ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def _out(size: int, k: int, stride: int) -> int:
    pad = k // 2
    return (size + 2 * pad - k) // stride + 1


def conv_flops(cin: int, cout: int, k: int, h: int, w: int) -> int:
    return 2 * cin * cout * k * k * h * w


def level_sizes(S: int) -> list:
    """P2..P6 side lengths at input side S."""
    s = _out(S, 7, 2)                   # stem
    s = (s + 2 - 3) // 2 + 1            # 3x3/2 max pool, padding 1
    out = [s]
    for _ in range(3):
        s = _out(s, 1, 2)
        out.append(s)
    out.append(_out(out[-1], 1, 2))     # P6: stride-2 subsample of P5
    return out


def backbone_flops(st: dict, S: int) -> int:
    f = 0
    s = _out(S, 7, 2)
    f += conv_flops(3, st["stem_out"], 7, s, s)
    s = (s + 2 - 3) // 2 + 1
    cin, width = st["stem_out"], st["res2_out"]
    res = []
    for si, nb in enumerate(st["resnet_blocks"]):
        mid = width // 4
        for bi in range(nb):
            stride = 2 if (si > 0 and bi == 0) else 1
            so = _out(s, 1, stride)
            f += conv_flops(cin, mid, 1, so, so)
            f += conv_flops(mid, mid, 3, so, so)
            f += conv_flops(mid, width, 1, so, so)
            if bi == 0:
                f += conv_flops(cin, width, 1, so, so)
            cin, s = width, so
        res.append((width, s))
        width *= 2
    C = st["fpn_channels"]
    for c_in, s in res:
        f += conv_flops(c_in, C, 1, s, s) + conv_flops(C, C, 3, s, s)
    return f


def forward_flops(st: dict, tile_px: int) -> int:
    """FLOPs of one tile's convolutions and matrix products (see the
    module's rules)."""
    S = st["min_size_test"]
    f = 0
    if S != tile_px:
        f += 2 * 3 * S * tile_px * (tile_px + S)
    f += backbone_flops(st, S)
    C, A = st["fpn_channels"], len(st["anchor_aspect_ratios"])
    for s in level_sizes(S):
        f += conv_flops(C, C, 3, s, s) + conv_flops(C, A, 1, s, s) \
            + conv_flops(C, 4 * A, 1, s, s)
    R, P = st["rpn_post_nms_topk_test"], st["box_pooler_resolution"]
    fc, K = st["box_fc_dim"], st["num_classes"]
    f += 2 * R * (C * P * P * fc + fc * fc + fc * (K + 1) + fc * 4 * K)
    D, Pm, M = st["detections_per_image"], st["mask_pooler_resolution"], \
        st["mask_conv_dim"]
    cin = C
    for _ in range(st["mask_num_conv"]):
        f += D * conv_flops(cin, M, 3, Pm, Pm)
        cin = M
    f += D * 2 * cin * M * 4 * Pm * Pm             # 2x2 stride-2 deconv
    f += D * conv_flops(M, K, 1, 2 * Pm, 2 * Pm)
    return f


def pooler_bytes(st: dict, precision: str) -> int:
    """Lower bound on the bytes of one tile's two pooler calls."""
    C, item = st["fpn_channels"], ITEM[precision]
    R, P = st["rpn_post_nms_topk_test"], st["box_pooler_resolution"]
    D, Pm = st["detections_per_image"], st["mask_pooler_resolution"]
    return R * 16 + R * P * P * C * item + D * 16 + D * Pm * Pm * C * item


def nms_bytes(st: dict) -> int:
    """Bytes of one tile's exact-NMS calls: the RPN's per-level
    candidates and the (proposal, class) candidates."""
    S = st["min_size_test"]
    A = len(st["anchor_aspect_ratios"])
    rpn = sum(min(st["rpn_pre_nms_topk_test"], s * s * A)
              for s in level_sizes(S))
    cls = st["rpn_post_nms_topk_test"] * st["num_classes"]
    return (rpn + cls) * (16 + 4 + 1)
