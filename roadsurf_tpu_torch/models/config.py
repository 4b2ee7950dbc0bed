"""Model configuration for the Mask R-CNN detector: R50-FPN, or ViTDet.

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

A second backbone, ``backbone="vit"``: ViTDet's plain ViT with windowed and
global attention and its simple feature pyramid, with the two-conv RPN head
and the LN box and mask heads (:func:`vitdet_b`; ``models/vit.py``). Its
fields default to ViT-B's and are not read by the R50-FPN.
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
    # "resnet50" (ResNet-50 + FPN) or "vit" (ViTDet: plain ViT + simple
    # feature pyramid, models/vit.py; detectron2 projects/ViTDet)
    backbone: str = "resnet50"
    vit_patch: int = 16
    vit_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    vit_mlp_ratio: float = 4.0
    # blocks not in vit_global_blocks attend within vit_window² windows
    vit_window: int = 14
    vit_global_blocks: tuple = (2, 5, 8, 11)
    # the absolute position embedding's pretraining grid (224 px / 16),
    # with a class token, resized to the input's grid
    vit_pretrain_grid: int = 14
    ln_eps: float = 1e-6
    sfp_scales: tuple = (4.0, 2.0, 1.0, 0.5)

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
    # 3x3 convs with ReLU in the RPN head (conv_dims; ViTDet's [-1, -1])
    rpn_num_conv: int = 1

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
    # the box head's 3x3 convs at the pooled width before its FCs, and the
    # FCs (FastRCNNConvFCHead: 2fc for R50, 4conv1fc for ViTDet)
    box_num_conv: int = 0
    box_num_fc: int = 2
    box_bbox_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    mask_conv_dim: int = 256
    mask_num_conv: int = 4
    # "" or "LN": the box and mask heads' convs without bias, each followed
    # by a channel LayerNorm (ln_eps) before its ReLU
    head_norm: str = ""
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
    # static-int8 stack (models/quant.py): int8_backbone quantizes the
    # ResNet (the legacy state["backbone_q"], or state["quant"]["backbone"]);
    # int8_scope "backbone" / "convnet" (+ FPN, RPN head) / "full" (+ box
    # FCs, mask head) runs state["quant"] from prepare_quantized; an int8
    # config without that state runs in compute_dtype. int8_pyramid keeps
    # P2..P6 int8 in per-level scales (scopes "convnet" and "full")
    int8_backbone: bool = False
    int8_scope: str = ""
    int8_pyramid: bool = False
    # training knobs (reference config.py:124-147; engine/train.py)
    train_remat: bool = False
    train_mask_rois: int = 128
    train_head_chunks: int = 1

    def __post_init__(self):
        if self.backbone not in ("resnet50", "vit"):
            raise ValueError(f"backbone must be 'resnet50' or 'vit', got "
                             f"{self.backbone!r}")
        if self.backbone == "vit" and (self.int8_backbone or self.int8_scope
                                       or self.int8_pyramid):
            raise ValueError("the int8 stack (int8_backbone, int8_scope, "
                             "int8_pyramid) quantizes the ResNet-50 and FPN; "
                             "backbone='vit' has none")
        if self.box_num_conv and self.head_norm != "LN":
            raise ValueError("the box head's convs (box_num_conv) run with "
                             "head_norm='LN' only")

    @property
    def fpn_strides(self) -> tuple:
        return (4, 8, 16, 32, 64)   # P2..P6

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_aspect_ratios)


def field(cfg, name: str):
    """``cfg.<name>``, or :class:`ModelConfig`'s default where ``cfg`` has
    no such field: the reference package's config, which the parity tests
    hand to the port, runs the R50-FPN."""
    return getattr(cfg, name, getattr(ModelConfig, name))


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


def vitdet_b(cfg: ModelConfig | None = None) -> ModelConfig:
    """ViTDet-B Mask R-CNN at its published 1024 px input (detectron2
    projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py, through
    configs/common/models/mask_rcnn_vitdet.py): ViT-B/16, 14x14 windows with
    global blocks 2, 5, 8 and 11, the simple feature pyramid, a two-conv RPN
    head, the 4conv1fc box head and the mask head, both with LN; RGB pixel
    mean and std; the parity profile's test budgets."""
    cfg = cfg or ModelConfig()
    return replace(cfg, backbone="vit",
                   pixel_mean=(123.675, 116.28, 103.53),
                   pixel_std=(58.395, 57.12, 57.375),
                   min_size_test=1024, max_size_test=1024,
                   vit_patch=16, vit_dim=768, vit_depth=12, vit_heads=12,
                   vit_mlp_ratio=4.0, vit_window=14,
                   vit_global_blocks=(2, 5, 8, 11), vit_pretrain_grid=14,
                   ln_eps=1e-6, sfp_scales=(4.0, 2.0, 1.0, 0.5),
                   rpn_num_conv=2, box_num_conv=4, box_num_fc=1,
                   head_norm="LN")


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
