"""The training step of the PyTorch port against the JAX package's on the
profile the YAML trains (``config/detectron2_config_3bands.yaml``:
adaptive pooler sampling, POOLER_SAMPLING_RATIO 0; exact greedy NMS), on
the CPU in float32 at a narrow width and 128 px tiles, with the proposal
and ROI budgets cut (300 pre-NMS and 100 post-NMS proposals a level, 64
ROIs and 32 anchors an image) so that the test stays short. Same checks
and tolerances as ``tests/test_torch_train_step.py``.
"""

import os
from dataclasses import replace

import pytest
import torch

from roadsurf_tpu.models.config import from_detectron2_yaml as j_from_yaml
from roadsurf_tpu_torch.models.config import from_detectron2_yaml
from test_torch_train_step import NARROW, check_step

torch.set_num_threads(1)

YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "detectron2_config_3bands.yaml")


def test_yaml_profile_losses_and_one_step_match_jax():
    S = 128
    knobs = dict(NARROW, min_size_test=S, max_size_test=S,
                 rpn_pre_nms_topk_train=300, rpn_post_nms_topk_train=100,
                 roi_batch_per_image=64, rpn_batch_per_image=32)
    jcfg = replace(j_from_yaml(YAML), **knobs)
    tcfg = replace(from_detectron2_yaml(YAML), **knobs)
    assert tcfg.pooler_sampling_ratio == 0 and not tcfg.fast_nms
    assert tcfg.freeze_at == 2
    check_step(jcfg, tcfg, S)


@pytest.mark.slow
def test_yaml_profile_one_step_at_its_full_budgets():
    """256 px tiles with the YAML's own budgets (2000 pre-NMS and 1000
    post-NMS proposals, 1024 ROIs and 256 anchors an image, mask ROIs
    capped at 128), narrow width."""
    S = 256
    knobs = dict(NARROW, min_size_test=S, max_size_test=S)
    jcfg = replace(j_from_yaml(YAML), **knobs)
    tcfg = replace(from_detectron2_yaml(YAML), **knobs)
    assert (tcfg.rpn_pre_nms_topk_train, tcfg.rpn_post_nms_topk_train,
            tcfg.roi_batch_per_image, tcfg.rpn_batch_per_image,
            tcfg.train_mask_rois) == (2000, 1000, 1024, 256, 128)
    check_step(jcfg, tcfg, S)
