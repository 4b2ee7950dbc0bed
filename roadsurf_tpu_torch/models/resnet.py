"""ResNet-50 backbone with frozen BatchNorm folded into the conv weights.

Port of the reference backbone (detectron2_config_3bands.yaml:92-111 —
DEPTH 50, NORM FrozenBN, STRIDE_IN_1X1 true, RES2_OUT 256, STEM_OUT 64).
Activations are NCHW tensors in ``channels_last`` memory (``x.permute(0, 2,
3, 1)`` is then a contiguous NHWC view, the reference's layout). FrozenBN
is folded at weight-conversion time (utils/weights.py): each unit is
``{"w": OIHW weight·scale, "b": bias}``, and the bias rides the conv. On
the card in inference (``ops.bias_act.conv_epilogue``) a conv runs without
its bias, and one pass of the epilogue kernel applies the bias, the ReLU
and the bottleneck's residual sum to its output, bit for bit as the plain
ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.bias_act import conv_epilogue

BLOCKS_PER_STAGE = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def conv_fn(p: dict, stride: int = 1):
    """The unit's conv with the reference's padding, as a function of its
    input and a bias (the unit's, or None): k//2 per side for k > 1, none
    for 1x1 (a strided 1x1 samples every ``stride``-th pixel)."""
    k = p["w"].shape[-1]
    return lambda x, b: F.conv2d(x, p["w"], b, stride=stride,
                                 padding=k // 2)


def conv(x: torch.Tensor, p: dict, stride: int = 1, relu: bool = False,
         coarser: torch.Tensor | None = None) -> torch.Tensor:
    """The unit's conv with its bias, plus the coarser FPN level's 2x
    upsample where ``coarser``, then ReLU where ``relu``
    (``ops.bias_act.conv_epilogue``)."""
    return conv_epilogue(conv_fn(p, stride), x, p["b"], relu=relu,
                         coarser=coarser)


def bottleneck(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """Bottleneck block, stride in the 1x1 conv (detectron2 convention,
    detectron2_config_3bands.yaml:111): ``relu(conv3 + shortcut)``, the
    shortcut a conv of ``x`` or ``x`` itself."""
    out = conv(x, p["conv1"], stride, relu=True)
    out = conv(out, p["conv2"], relu=True)
    sp = p.get("shortcut")
    return conv_epilogue(
        conv_fn(p["conv3"]), out, p["conv3"]["b"], relu=True,
        residual=x if sp is None else None,
        shortcut=None if sp is None else (conv_fn(sp, stride), x, sp["b"]))


def max_pool(x: torch.Tensor) -> torch.Tensor:
    # 3x3/2 with one pixel of -inf padding per side (reduce_window init)
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def resnet_forward(params: dict, images: torch.Tensor) -> dict:
    """images: (B, 3, H, W) in the compute dtype; returns {'res2'..'res5'}."""
    x = conv(images, params["stem"], stride=2, relu=True)
    x = max_pool(x)
    feats = {}
    for si, stage in enumerate(["res2", "res3", "res4", "res5"]):
        first_stride = 1 if si == 0 else 2
        for bi, bp in enumerate(params[stage]):
            x = bottleneck(x, bp, stride=first_stride if bi == 0 else 1)
        feats[stage] = x
    return feats
