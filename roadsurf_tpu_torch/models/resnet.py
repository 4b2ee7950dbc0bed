"""ResNet-50 backbone with frozen BatchNorm folded into the conv weights.

Port of the reference backbone (detectron2_config_3bands.yaml:92-111 —
DEPTH 50, NORM FrozenBN, STRIDE_IN_1X1 true, RES2_OUT 256, STEM_OUT 64).
Activations are NCHW tensors in ``channels_last`` memory (``x.permute(0, 2,
3, 1)`` is then a contiguous NHWC view, the reference's layout). FrozenBN
is folded at weight-conversion time (utils/weights.py): each unit is
``{"w": OIHW weight·scale, "b": bias}``, and the bias rides the conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCKS_PER_STAGE = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def conv(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """Conv with the reference's padding: k//2 per side for k > 1, none
    for 1x1 (a strided 1x1 samples every ``stride``-th pixel)."""
    k = p["w"].shape[-1]
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=k // 2)


def conv_bn(x: torch.Tensor, p: dict, stride: int = 1,
            relu: bool = True) -> torch.Tensor:
    y = conv(x, p, stride)
    return torch.relu_(y) if relu else y


def bottleneck(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """Bottleneck block, stride in the 1x1 conv (detectron2 convention,
    detectron2_config_3bands.yaml:111)."""
    out = conv_bn(x, p["conv1"], stride=stride)
    out = conv_bn(out, p["conv2"])
    out = conv_bn(out, p["conv3"], relu=False)
    sc = conv_bn(x, p["shortcut"], stride=stride, relu=False) \
        if "shortcut" in p else x
    return torch.relu_(out + sc)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    # 3x3/2 with one pixel of -inf padding per side (reduce_window init)
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def resnet_forward(params: dict, images: torch.Tensor) -> dict:
    """images: (B, 3, H, W) in the compute dtype; returns {'res2'..'res5'}."""
    x = conv_bn(images, params["stem"], stride=2)
    x = max_pool(x)
    feats = {}
    for si, stage in enumerate(["res2", "res3", "res4", "res5"]):
        first_stride = 1 if si == 0 else 2
        for bi, bp in enumerate(params[stage]):
            x = bottleneck(x, bp, stride=first_stride if bi == 0 else 1)
        feats[stage] = x
    return feats
