"""Feature Pyramid Network over the ResNet backbone.

Pinned behavior (reference detectron2_config_3bands.yaml:61-69): lateral 1x1
convs on res2..res5, top-down nearest-2x upsampling with sum fusion, 3x3
output convs, and P6 = stride-2 window-1 max of P5 (LastLevelMaxPool).
"""

from __future__ import annotations

import torch

from ..ops.bias_act import upsample2x_nearest  # noqa: F401 (the int8 FPNs)
from .resnet import conv


def fpn_forward(params: dict, feats: dict) -> list:
    """feats: {'res2'..'res5'}; returns [P2, P3, P4, P5, P6], each NCHW in
    channels_last memory."""
    names = ["res2", "res3", "res4", "res5"]
    tds = [None] * 5
    for i in (3, 2, 1, 0):
        # the lateral conv plus the coarser level's nearest 2x upsample
        tds[i] = conv(feats[names[i]], params[f"lateral{i + 2}"],
                      coarser=tds[i + 1])
    outs = [conv(tds[i].contiguous(memory_format=torch.channels_last),
                 params[f"output{i + 2}"]) for i in range(4)]
    # a window-1 stride-2 max is a plain subsample
    outs.append(outs[3][:, :, ::2, ::2].contiguous(
        memory_format=torch.channels_last))
    return outs
