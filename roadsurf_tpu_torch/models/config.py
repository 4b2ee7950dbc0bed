"""Model configuration for the Mask R-CNN R50-FPN detector.

A copy of the reference package's ``ModelConfig`` and its profiles (the port
imports nothing of the JAX package), so the same YAML and profile calls give
the same configuration in both. Knobs mirror the detectron2 YAML
(config/detectron2_config_3bands.yaml — anchor sizes :51-55, RPN topk/NMS
:222-251, ROI heads :177-221, solver :268-305, input :19-38).

Two execution profiles:
* ``parity``  — the reference inference geometry (resize shorter side to
  800, 1000 post-NMS proposals, adaptive pooler sampling);
* ``fast``    — native 256px tiles, fewer proposals, fixed 2x2 pooler
  sampling; same weights, same math per proposal.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import yaml


@dataclass(frozen=True)
class ModelConfig:
    # input
    num_classes: int = 2            # artificial / natural (det_class 0/1)
    pixel_mean: tuple = (103.53, 116.28, 123.675)
    pixel_std: tuple = (1.0, 1.0, 1.0)
    min_size_test: int = 800
    max_size_test: int = 1333
    min_size_train: tuple = (640, 672, 704, 736, 768, 800)
    max_size_train: int = 1333

    # backbone
    freeze_at: int = 2
    fpn_channels: int = 256

    # anchors (one size per FPN level P2..P6, 3 aspect ratios)
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_aspect_ratios: tuple = (0.5, 1.0, 2.0)
    anchor_offset: float = 0.0

    # RPN
    rpn_pre_nms_topk_train: int = 2000
    rpn_pre_nms_topk_test: int = 1000
    rpn_post_nms_topk_train: int = 1000
    rpn_post_nms_topk_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_iou_thresholds: tuple = (0.3, 0.7)
    rpn_bbox_weights: tuple = (1.0, 1.0, 1.0, 1.0)
    rpn_smooth_l1_beta: float = 0.0

    # ROI heads
    roi_batch_per_image: int = 1024
    roi_positive_fraction: float = 0.25
    roi_iou_threshold: float = 0.5
    box_pooler_resolution: int = 7
    mask_pooler_resolution: int = 14
    # 0 = POOLER_SAMPLING_RATIO 0 (per-ROI adaptive ceil,
    # detectron2_config_3bands.yaml:174); the fast profile pins the fixed
    # 2x2 grid
    pooler_sampling_ratio: int = 0
    box_fc_dim: int = 1024
    box_bbox_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    mask_conv_dim: int = 256
    mask_num_conv: int = 4
    score_thresh_test: float = 0.05
    nms_thresh_test: float = 0.5
    detections_per_image: int = 100
    canonical_box_size: int = 224
    canonical_level: int = 4

    # solver (reference detectron2_config_3bands.yaml:268-305)
    base_lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    max_iter: int = 12000
    gamma: float = 0.8
    # the 16 LR-decay milestones pinned by the reference
    # (detectron2_config_3bands.yaml:283-299)
    steps: tuple = (3000, 4000, 5000, 5500, 6000, 6500, 7000, 7500, 8000,
                    8500, 9000, 9500, 10000, 10500, 11000, 11500)
    warmup_iters: int = 200
    warmup_factor: float = 0.001
    ims_per_batch: int = 8
    checkpoint_period: int = 500
    eval_period: int = 200

    # execution
    compute_dtype: str = "bfloat16"
    # single-sweep NMS (ops/nms.nms_sweep) instead of exact greedy
    fast_nms: bool = False
    # spatial local-max pre-gate on RPN objectness before the pre-NMS top-k
    # (models/rpn._local_max_gate); only honored with fast_nms
    rpn_local_max_gate: bool = False
    # the reference's switch for its TPU pooler kernel; the port picks its
    # pooler from the tensor's device and never reads this field
    pallas_pooler: bool = True
    # static-int8 stack (reference models/quant.py); not ported yet —
    # forward_inference raises when any of these is set
    int8_backbone: bool = False
    int8_scope: str = ""
    int8_pyramid: bool = False
    # training knobs (reference config.py:124-147); training is not ported
    train_remat: bool = False
    train_mask_rois: int = 128
    train_head_chunks: int = 1

    @property
    def fpn_strides(self) -> tuple:
        return (4, 8, 16, 32, 64)   # P2..P6

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_aspect_ratios)


def fast_profile(cfg: ModelConfig | None = None, *,
                 post_nms_topk: int = 64,
                 detections_per_image: int = 8) -> ModelConfig:
    """Throughput profile: native tile resolution, trimmed proposal and
    detection counts (a 256px road tile holds a handful of instances)."""
    cfg = cfg or ModelConfig()
    return replace(cfg,
                   min_size_test=256, max_size_test=256,
                   rpn_pre_nms_topk_test=max(64, post_nms_topk),
                   rpn_post_nms_topk_test=post_nms_topk,
                   detections_per_image=detections_per_image,
                   pooler_sampling_ratio=2,
                   fast_nms=True,
                   rpn_local_max_gate=True)


def dense_profile(cfg: ModelConfig | None = None) -> ModelConfig:
    """Crowded-scene profile: pre-NMS 1024, 256 proposals, 16 detections,
    exact greedy NMS, at native tile resolution."""
    cfg = cfg or ModelConfig()
    return replace(cfg,
                   min_size_test=256, max_size_test=256,
                   rpn_pre_nms_topk_test=1024,
                   rpn_post_nms_topk_test=256,
                   detections_per_image=16,
                   pooler_sampling_ratio=2,
                   fast_nms=False)


def from_detectron2_yaml(path: str, num_classes: int = 2) -> ModelConfig:
    """Load a detectron2-format YAML (the reference's
    config/detectron2_config_3bands.yaml) into a ModelConfig."""
    with open(path) as f:
        d = yaml.safe_load(f)
    m = d.get("MODEL", {})
    inp = d.get("INPUT", {})
    sol = d.get("SOLVER", {})
    tst = d.get("TEST", {})
    rpn = m.get("RPN", {})
    roi = m.get("ROI_HEADS", {})
    box = m.get("ROI_BOX_HEAD", {})
    msk = m.get("ROI_MASK_HEAD", {})
    anch = m.get("ANCHOR_GENERATOR", {})

    def flat_sizes(sizes):
        return tuple(s[0] if isinstance(s, (list, tuple)) else s
                     for s in sizes)

    # detectron2 counts "thing" classes in ROI_HEADS.NUM_CLASSES; the
    # pipeline distinguishes det_class 0/1, so the caller passes the count
    return ModelConfig(
        num_classes=num_classes,
        pixel_mean=tuple(m.get("PIXEL_MEAN", (103.53, 116.28, 123.675))),
        pixel_std=tuple(m.get("PIXEL_STD", (1.0, 1.0, 1.0))),
        min_size_test=inp.get("MIN_SIZE_TEST", 800),
        max_size_test=inp.get("MAX_SIZE_TEST", 1333),
        min_size_train=tuple(inp.get("MIN_SIZE_TRAIN", (800,))),
        max_size_train=inp.get("MAX_SIZE_TRAIN", 1333),
        freeze_at=m.get("BACKBONE", {}).get("FREEZE_AT", 2),
        fpn_channels=m.get("FPN", {}).get("OUT_CHANNELS", 256),
        anchor_sizes=flat_sizes(anch.get("SIZES",
                                         ((32,), (64,), (128,), (256,), (512,)))),
        anchor_aspect_ratios=tuple(
            anch.get("ASPECT_RATIOS", [[0.5, 1.0, 2.0]])[0]),
        anchor_offset=anch.get("OFFSET", 0.0),
        rpn_pre_nms_topk_train=rpn.get("PRE_NMS_TOPK_TRAIN", 2000),
        rpn_pre_nms_topk_test=rpn.get("PRE_NMS_TOPK_TEST", 1000),
        rpn_post_nms_topk_train=rpn.get("POST_NMS_TOPK_TRAIN", 1000),
        rpn_post_nms_topk_test=rpn.get("POST_NMS_TOPK_TEST", 1000),
        rpn_nms_thresh=rpn.get("NMS_THRESH", 0.7),
        rpn_batch_per_image=rpn.get("BATCH_SIZE_PER_IMAGE", 256),
        rpn_positive_fraction=rpn.get("POSITIVE_FRACTION", 0.5),
        rpn_iou_thresholds=tuple(rpn.get("IOU_THRESHOLDS", (0.3, 0.7))),
        rpn_smooth_l1_beta=rpn.get("SMOOTH_L1_BETA", 0.0),
        roi_batch_per_image=roi.get("BATCH_SIZE_PER_IMAGE", 1024),
        roi_positive_fraction=roi.get("POSITIVE_FRACTION", 0.25),
        roi_iou_threshold=tuple(roi.get("IOU_THRESHOLDS", (0.5,)))[0],
        box_pooler_resolution=box.get("POOLER_RESOLUTION", 7),
        mask_pooler_resolution=msk.get("POOLER_RESOLUTION", 14),
        pooler_sampling_ratio=box.get("POOLER_SAMPLING_RATIO", 0),
        box_fc_dim=box.get("FC_DIM", 1024),
        box_bbox_weights=tuple(box.get("BBOX_REG_WEIGHTS",
                                       (10.0, 10.0, 5.0, 5.0))),
        mask_conv_dim=msk.get("CONV_DIM", 256),
        mask_num_conv=msk.get("NUM_CONV", 4),
        score_thresh_test=roi.get("SCORE_THRESH_TEST", 0.05),
        nms_thresh_test=roi.get("NMS_THRESH_TEST", 0.5),
        detections_per_image=tst.get("DETECTIONS_PER_IMAGE", 100),
        base_lr=sol.get("BASE_LR", 0.01),
        momentum=sol.get("MOMENTUM", 0.9),
        weight_decay=sol.get("WEIGHT_DECAY", 1e-4),
        max_iter=sol.get("MAX_ITER", 12000),
        gamma=sol.get("GAMMA", 0.8),
        steps=tuple(sol.get("STEPS", ())),
        warmup_iters=sol.get("WARMUP_ITERS", 200),
        warmup_factor=sol.get("WARMUP_FACTOR", 0.001),
        ims_per_batch=sol.get("IMS_PER_BATCH", 8),
        checkpoint_period=sol.get("CHECKPOINT_PERIOD", 500),
        eval_period=tst.get("EVAL_PERIOD", 200),
    )
