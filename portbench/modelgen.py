"""Inputs of every run, and the R50-FPN family's weights
(``families/r50_fpn.py``), made from ``--seed`` on the run's device.

Weights: the benchmark's own seeded initialiser, in the layout of
``roadsurf_tpu_torch``'s inference state (FrozenBN folded: each conv a
``{w: OIHW, b}``, linears ``(out, in)``, the mask deconv ``(in, out, kh,
kw)``, box-head fc1 rows in (p, q, c) order), made with one
``torch.Generator`` on the device in one draw, cut into leaves and cast to
the served dtype. Both the program and the plain reference get these very
tensors. The scales give a network whose outputs are neither constant nor
saturated at either profile: He (fan-in) convolutions, the stem's scaled
by ``STEM_GAIN`` so that the pixel range (pixel_std is 1) gives pyramid
levels of about unit size, the residual branch's last conv damped by
``RESIDUAL``, the box head's rows centred, class logits spread by
``CLS_SPREAD``, and small box deltas. The class biases are then pinned
(:func:`pin_classes`) so that every seed yields about as many
detections: ``PASS_SHARE`` of each class's candidates over the score
threshold on the pool's first tiles.

Tiles: a pool of distinct uint8 (N, T, T, 3) tiles, smooth colour fields
at three scales, made on the device from the same generator and copied to
host memory, where the engine's users hold their tiles.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

STEM_GAIN = 1.0 / 256  # the stem's He std, times this: unit-scale levels
RESIDUAL = 0.25         # the residual branch's last conv, times He
RPN_STD = 0.01
CLS_SPREAD = 2.0        # class logits' spread on unit features
PASS_SHARE = 0.04       # of each class's candidates over the threshold
PIN_TILES = 8
BBOX_STD = 0.002
TILE_CHUNK = 512        # tiles made a call on the device


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def leaves(st: dict) -> list:
    """(path, shape, std, extra) of every weight, in the order of the
    draw: convs OIHW with He fan-in std, linears (out, in); ``extra`` is a
    bias's values, or "centred" for a weight whose rows are made zero-mean,
    or None."""
    out = []

    def conv(path, cin, cout, k, gain=1.0):
        out.append((path + ("w",), (cout, cin, k, k),
                    gain * math.sqrt(2.0 / (cin * k * k)), None))
        out.append((path + ("b",), (cout,), 0.0, None))

    cin = 3
    conv(("backbone", "stem"), cin, st["stem_out"], 7, STEM_GAIN)
    cin, width = st["stem_out"], st["res2_out"]
    for si, nb in enumerate(st["resnet_blocks"]):
        stage = f"res{si + 2}"
        mid = width // 4
        for bi in range(nb):
            base = ("backbone", stage, bi)
            conv(base + ("conv1",), cin, mid, 1)
            conv(base + ("conv2",), mid, mid, 3)
            conv(base + ("conv3",), mid, width, 1, RESIDUAL)
            if bi == 0:
                conv(base + ("shortcut",), cin, width, 1)
            cin = width
        width *= 2
    C = st["fpn_channels"]
    for i, c_in in enumerate(st["res2_out"] * 2 ** j for j in range(4)):
        conv(("fpn", f"lateral{i + 2}"), c_in, C, 1)
        conv(("fpn", f"output{i + 2}"), C, C, 3)
    A = len(st["anchor_aspect_ratios"])
    for name, cout, k in (("conv", C, 3), ("objectness", A, 1),
                          ("deltas", 4 * A, 1)):
        out.append((("rpn", name, "w"), (cout, C, k, k),
                    RPN_STD if name != "conv" else math.sqrt(2.0 / (9 * C)),
                    None))
        out.append((("rpn", name, "b"), (cout,), 0.0, None))
    P, fc, K = st["box_pooler_resolution"], st["box_fc_dim"], \
        st["num_classes"]
    # the box head's rows are centred (zero mean over their inputs), so
    # that the ReLU features' common positive mean gives no unit and no
    # class a seed-dependent offset
    for name, cin_, cout, std in (
            ("fc1", C * P * P, fc, math.sqrt(2.0 / (C * P * P))),
            ("fc2", fc, fc, math.sqrt(2.0 / fc)),
            ("cls", fc, K + 1, CLS_SPREAD / math.sqrt(fc)), ("bbox", fc, 4 * K, BBOX_STD)):
        out.append((("box_head", name, "w"), (cout, cin_), std, "centred"
                    if name != "bbox" else None))
        out.append((("box_head", name, "b"), (cout,), 0.0, None))
    M, cin = st["mask_conv_dim"], C
    for i in range(st["mask_num_conv"]):
        conv(("mask_head", f"conv{i + 1}"), cin, M, 3)
        cin = M
    out.append((("mask_head", "deconv", "w"), (cin, M, 2, 2),
                math.sqrt(2.0 / (4 * cin)), None))
    out.append((("mask_head", "deconv", "b"), (M,), 0.0, None))
    conv(("mask_head", "predictor"), M, K, 1)
    return out


def _put(tree: dict, path: tuple, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def weights(st: dict, g: torch.Generator, device, dtype) -> dict:
    """The state: every leaf of :func:`leaves`, cut from one normal draw
    of the generator on ``device``, in ``dtype``, 4-d tensors in
    channels_last memory."""
    spec = leaves(st)
    total = sum(math.prod(shape) for _, shape, std, _ in spec if std)
    flat = torch.randn(total, generator=g, device=device)
    state: dict = {}
    off = 0
    for path, shape, std, bias in spec:
        n = math.prod(shape)
        if std:
            t = flat[off:off + n].view(shape) * std
            off += n
            if bias == "centred":
                t = t - t.mean(dim=1, keepdim=True)
        elif bias is not None:
            t = torch.tensor(bias, device=device)
        else:
            t = torch.zeros(shape, device=device)
        t = t.to(dtype)
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        _put(state, path, t)
    return state


def tiles(n: int, px: int, g: torch.Generator, device) -> np.ndarray:
    """(n, px, px, 3) uint8 host tiles: colour fields at 1/32, 1/8 and
    full resolution, summed and clipped."""
    out = np.empty((n, px, px, 3), np.uint8)
    for i in range(0, n, TILE_CHUNK):
        m = min(TILE_CHUNK, n - i)
        x = torch.zeros((m, 3, px, px), device=device)
        for cells, amp in ((max(px // 32, 1), 150.0), (max(px // 8, 1), 70.0),
                           (px, 30.0)):
            r = torch.rand((m, 3, cells, cells), generator=g, device=device)
            if cells != px:
                r = F.interpolate(r, size=(px, px), mode="bilinear",
                                  align_corners=False)
            x += r * amp
        u8 = x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        out[i:i + m] = u8.cpu().numpy()
    return out


@torch.no_grad()
def pin_classes(state: dict, st: dict, tiles_u8: np.ndarray, device):
    """Set each class's bias so that ``PASS_SHARE`` of its (proposal,
    class) candidates on ``tiles_u8`` score at least the threshold, by
    bisection on the plain reference's float32 class logits."""
    from . import reference as R

    x = torch.from_numpy(tiles_u8).to(device)
    with R.no_tf32():
        feats = R.backbone_fpn(state, R.preprocess(x, st))
        props, _, valid = R.proposals(*R.rpn(state, feats), R.anchors(
            st["min_size_test"], st, device), st)
        logits = torch.cat([R.box_head(state, R.roi_align(
            [f[j] for f in feats[:4]], props[j][valid[j]],
            st["box_pooler_resolution"], st))[0]
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
            lo, hi = (lo, mid) if share > PASS_SHARE else (mid, hi)
        b[c] = b[c] + 0.5 * (lo + hi)
