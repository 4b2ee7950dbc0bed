"""GeneralizedRCNN (Mask R-CNN R50-FPN, or ViTDet) inference assembly.

  uint8 tiles -> [optional resize to MIN_SIZE_TEST] -> normalize
  -> ResNet-50 + FPN (or ViT + simple feature pyramid, ``models/vit.py``)
  -> RPN proposals -> box head -> fixed-shape class NMS
  -> mask head on the detections -> 28x28 per-instance masks.

Port of the reference's ``forward_inference``, with its static-int8
branches (``models/quant.py``): an int8 config whose state carries the
calibrated ``quant`` (or legacy ``backbone_q``) group runs the int8 stack,
and without one it runs in the compute dtype, as the reference's
``_quant_tree`` decides. The state is the one ``utils.weights.
from_jax_params`` builds, with ``quant`` from ``from_jax_quant`` or the
port's ``quant.prepare_quantized``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.device import compute_dtype, device_constant, resolve_device
from ..utils.graphs import CapturedGraph, storage_key, tensor_leaves
from ..utils.profiling import span
from ..utils.weights import state_to
from . import vit
from .anchors import anchors_on
from .config import ModelConfig, field
from .fpn import fpn_forward
from .quant import fpn_forward_int8, fpn_forward_int8_pyr, \
    resnet_forward_int8, rpn_head_forward_int8, rpn_head_forward_int8_pyr
from .resnet import BLOCKS_PER_STAGE, resnet_forward
from .roi_heads import box_head_forward, inference_detections, \
    mask_head_forward
from .rpn import rpn_head_forward, select_proposals

MASK_FORMATS = ("logits", "u8", "both", "bits")


@functools.lru_cache(maxsize=None)
def _resize_weights(src: int, dst: int, device: torch.device
                    ) -> torch.Tensor:
    """:func:`_bilinear_weights` on ``device``, made once (see
    ``utils.device.device_constant``)."""
    return torch.from_numpy(_bilinear_weights(src, dst)).to(device)


def _bilinear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) separable bilinear resize matrix (half-pixel centers,
    edge clamp)."""
    out = np.zeros((dst, src), np.float32)
    for i in range(dst):
        c = (i + 0.5) * src / dst - 0.5
        f = np.floor(c)
        w = c - f
        i0 = int(np.clip(f, 0, src - 1))
        i1 = int(np.clip(f + 1, 0, src - 1))
        out[i, i0] += 1 - w
        out[i, i1] += w
    return out


def preprocess(images: torch.Tensor, cfg: ModelConfig,
               input_size: int) -> torch.Tensor:
    """uint8/float (B, H, W, 3) -> normalized float32 (B, S, S, 3).

    The resize is two matmuls with the per-axis weight matrices; like the
    reference it resizes when H differs from ``input_size``."""
    x = images.float()
    if input_size != images.shape[1]:
        B, H, Wd, C = x.shape
        dev = x.device
        wy = _resize_weights(H, input_size, dev)
        wx = _resize_weights(Wd, input_size, dev)
        a = x.permute(1, 0, 2, 3).reshape(H, B * Wd * C)
        y = (wy @ a).reshape(input_size, B, Wd, C)
        b = y.permute(2, 1, 0, 3).reshape(Wd, B * input_size * C)
        z = (wx @ b).reshape(input_size, B, input_size, C)
        x = z.permute(1, 2, 0, 3)
    mean = device_constant(tuple(cfg.pixel_mean), x.device, torch.float32)
    std = device_constant(tuple(cfg.pixel_std), x.device, torch.float32)
    return (x - mean) / std


def check_config(cfg: ModelConfig, mask_format: str):
    if mask_format not in MASK_FORMATS:
        raise ValueError(f"mask_format must be one of {MASK_FORMATS}")


def _quant_tree(state: dict, cfg: ModelConfig) -> dict:
    """The calibrated int8 groups this config runs: ``state['quant']`` for
    an ``int8_scope``, its backbone (or the legacy ``state['backbone_q']``)
    for ``int8_backbone``; empty (run in the compute dtype) otherwise."""
    if cfg.int8_scope and "quant" in state:
        return state["quant"]
    if cfg.int8_backbone:
        if "quant" in state:
            return {"backbone": state["quant"]["backbone"]}
        if "backbone_q" in state:
            return {"backbone": state["backbone_q"]}
    return {}


def _backbone_fpn(state, q, x, dtype) -> list:
    """ResNet-50 and FPN on NCHW (channels_last) input, each int8 where
    ``q`` has its group: the P-levels, NCHW channels_last."""
    with span("forward.backbone"):
        if "backbone" in q:
            feats = resnet_forward_int8(q["backbone"], x)
        else:
            feats = resnet_forward(state["backbone"], x)
    with span("forward.fpn"):
        if "fpn" in q:
            return fpn_forward_int8(q["fpn"], feats, dtype)
        return fpn_forward(state["fpn"], {k: v.to(dtype)
                                          for k, v in feats.items()})


def forward_features(state: dict, x: torch.Tensor, cfg: ModelConfig,
                     dtype: torch.dtype, q: dict | None = None) -> list:
    """The reference's ``forward_features``: ResNet-50 and FPN of
    preprocessed images ``x`` (B, S, S, 3), int8 where the config's quant
    tree (or ``q``) has the group, else in ``dtype``. Returns the P-levels
    as NHWC (B, H_l, W_l, C) views, the reference's layout."""
    q = _quant_tree(state, cfg) if q is None else q
    x = x.to(dtype).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)
    return [f.permute(0, 2, 3, 1) for f in _backbone_fpn(state, q, x, dtype)]


def preprocessed(images: torch.Tensor, cfg: ModelConfig, dtype,
                 S: int) -> torch.Tensor:
    """:func:`preprocess` in ``dtype``, NCHW in channels_last memory: the
    backbone's float input."""
    return preprocess(images, cfg, S).to(dtype).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)


def backbone_input(images: torch.Tensor, cfg: ModelConfig, q: dict, dtype,
                   S: int) -> torch.Tensor:
    """What the backbone takes: the raw uint8 tiles (an NCHW view) where
    the int8 backbone has its uint8-direct stem (``quant.
    quantize_stem_u8``: the preprocess folds into the quantized stem) and
    the tiles are its size, else :func:`preprocessed`."""
    stem_u8 = q.get("backbone", {}).get("stem_u8")
    if (stem_u8 is not None and images.dtype == torch.uint8
            and images.shape[1] == S and images.shape[2] == S
            and stem_u8["bias"].shape[-1] == -(-S // 2)):
        return images.permute(0, 3, 1, 2)
    return preprocessed(images, cfg, dtype, S)


def pyramid_levels(state, q, x, cfg, dtype):
    """Backbone and FPN, each int8 where ``q`` has its group, or the ViT and
    its simple feature pyramid -> (P-levels NCHW channels_last, the levels'
    scales or None)."""
    if field(cfg, "backbone") == "vit":
        return vit.backbone_sfp(state, x, cfg), None
    pyr = q.get("pyr") if cfg.int8_pyramid else None
    if pyr is not None:
        # int8 pyramid: stage outputs, FPN and P-levels stay int8; the RPN
        # head and the poolers read the levels in their scales
        with span("forward.backbone"):
            res = resnet_forward_int8(q["backbone"], x,
                                      out_sas=pyr["res_sa"])
        with span("forward.fpn"):
            return fpn_forward_int8_pyr(q["fpn"], pyr, res, dtype), \
                pyr["out_sa"]
    return _backbone_fpn(state, q, x, dtype), None


def rpn_outputs(state, q, fpn_feats, cfg, dtype):
    """The RPN head on the P-levels, int8 where ``q`` has its group ->
    (objectness, deltas) per level."""
    pyr = q.get("pyr") if cfg.int8_pyramid else None
    if pyr is not None:
        return rpn_head_forward_int8_pyr(q["rpn"], pyr, fpn_feats)
    if "rpn" in q:
        return rpn_head_forward_int8(q["rpn"], fpn_feats)
    return rpn_head_forward(state["rpn"], [f.to(dtype) for f in fpn_feats],
                            cfg.num_anchors, field(cfg, "rpn_num_conv"))


def propose(logits, deltas, cfg: ModelConfig, S: int, device):
    """Proposal selection at the config's test budgets -> (proposals (B,
    K, 4), scores (B, K))."""
    anchors = anchors_on(S, cfg.fpn_strides, cfg.anchor_sizes,
                         cfg.anchor_aspect_ratios, cfg.anchor_offset, device)
    gate_geom = [(cfg.num_anchors, cfg.anchor_aspect_ratios, st, sz)
                 for st, sz in zip(cfg.fpn_strides, cfg.anchor_sizes)]
    return select_proposals(
        logits, deltas, anchors, S, cfg.rpn_pre_nms_topk_test,
        cfg.rpn_post_nms_topk_test, cfg.rpn_nms_thresh,
        fast_nms=cfg.fast_nms, local_max_gate=cfg.rpn_local_max_gate,
        gate_geom=gate_geom)


def pool_levels(fpn_feats: list) -> list:
    """P2..P5 as contiguous NHWC maps, what the poolers read."""
    return [f.permute(0, 2, 3, 1).contiguous() for f in fpn_feats[:4]]


def class_masks(state, q, box_feats, dets: dict, cfg: ModelConfig,
                feat_scales) -> torch.Tensor:
    """The mask head on the detections' boxes, each detection's own
    class channel -> mask logits (B, D, 2P, 2P), float32."""
    mask_logits = mask_head_forward(state["mask_head"], box_feats,
                                    dets["boxes"], cfg, qp=q.get("mask"),
                                    feat_scales=feat_scales)
    cls = dets["classes"].long()
    return torch.gather(
        mask_logits, -1,
        cls[:, :, None, None, None].expand(mask_logits.shape[:-1] + (1,))
    )[..., 0]


def prepare_state(state: dict, cfg: ModelConfig, device) -> dict:
    """The state placed for the config's forward (``state_to``), with the
    ViT's position embedding resized to the input's grid once
    (``vit.prepare``)."""
    state = state_to(state, device, compute_dtype(cfg))
    return vit.prepare(state, cfg) if field(cfg, "backbone") == "vit" \
        else state


def forward_prepared(state: dict, images: torch.Tensor, cfg: ModelConfig,
             with_masks: bool, mask_format: str) -> dict:
    """The forward on prepared weights (:func:`prepare_state`) and images
    already on their device. Its stages are spans
    (``utils.profiling.span``), in this order, each ATen op in one:
    ``forward.preprocess``, ``.backbone``, ``.fpn``, ``.rpn``,
    ``.box_head`` and ``.mask_head``."""
    dtype = compute_dtype(cfg)
    native = images.shape[1]
    S = cfg.min_size_test if cfg.min_size_test else native
    q = _quant_tree(state, cfg)
    with span("forward.preprocess"):
        x = backbone_input(images, cfg, q, dtype, S)
    fpn_feats, feat_scales = pyramid_levels(state, q, x, cfg, dtype)
    with span("forward.rpn"):
        logits, deltas = rpn_outputs(state, q, fpn_feats, cfg, dtype)
        proposals, prop_scores = propose(logits, deltas, cfg, S,
                                         images.device)

    with span("forward.box_head"):
        # box/mask pool from P2..P5, NHWC views of the channels_last maps
        box_feats = pool_levels(fpn_feats)
        class_logits, box_deltas = box_head_forward(
            state["box_head"], box_feats, proposals, cfg, qp=q.get("box"),
            feat_scales=feat_scales)
        dets = inference_detections(class_logits, box_deltas, proposals,
                                    prop_scores, cfg, S)
        boxes = dets["boxes"]
        # report boxes in native tile coordinates (the mask head pools
        # from ``boxes``, in the input's)
        dets["boxes"] = boxes * (native / S)

    if with_masks:
        with span("forward.mask_head"):
            masks = class_masks(state, q, box_feats, dict(dets, boxes=boxes),
                                cfg, feat_scales)
            if mask_format in ("logits", "both"):
                dets["mask_logits"] = masks
            if mask_format in ("u8", "both"):
                dets["mask_probs_u8"] = torch.round(
                    torch.sigmoid(masks) * 255.0).to(torch.uint8)
            if mask_format == "bits":
                # threshold at 0.5 (sigmoid(x) >= 0.5 <=> x >= 0) and pack
                # 8 cells per byte, little bit order (np.unpackbits(...,
                # bitorder="little") on the host)
                B2, D2 = masks.shape[:2]
                bits = (masks >= 0.0).reshape(B2, D2, -1, 8).to(torch.int32)
                weights = device_constant((1, 2, 4, 8, 16, 32, 64, 128),
                                          masks.device, torch.int32)
                dets["mask_bits"] = (bits * weights).sum(-1).to(torch.uint8)
    return dets


def forward_inference(state: dict, images, cfg: ModelConfig,
                      with_masks: bool = True, mask_format: str = "logits",
                      device="cuda") -> dict:
    """images: (B, H, W, 3) uint8 tiles (numpy or tensor). Returns a dict of
    tensors on ``device``: boxes (B, D, 4) in input-image coordinates,
    scores, classes, valid, and the masks in ``mask_format``. Raises when
    ``device`` names CUDA and no CUDA device is present."""
    device = resolve_device(device)
    check_config(cfg, mask_format)
    state = prepare_state(state, cfg, device)
    with torch.inference_mode():
        images = torch.as_tensor(images).to(device)
        return forward_prepared(state, images, cfg, with_masks, mask_format)


def capture_scan(per_slice, shape: tuple, device: torch.device
                 ) -> CapturedGraph:
    """A CUDA graph of ``per_slice`` (an image batch -> a dict of tensors)
    on each of the k slices of one static (k, B, H, W, 3) uint8 input,
    ``graph.static_in``; ``graph.outputs`` holds the results stacked on a
    leading k axis. The warm-up runs one slice (``utils/graphs.py``)."""
    static_in = torch.zeros(shape, dtype=torch.uint8, device=device)

    def body():
        outs = [per_slice(static_in[i]) for i in range(shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    graph = CapturedGraph(body, lambda: per_slice(static_in[0]), device)
    graph.static_in = static_in
    return graph


@functools.lru_cache(maxsize=32)
def make_inference_scan_fn(cfg: ModelConfig, with_masks: bool = True,
                           mask_format: str = "logits"):
    """The reference's ``make_inference_scan_fn``: returns ``fn(state,
    images)``, ``images`` (k, B, H, W, 3) uint8 (numpy or a tensor) and
    ``state`` prepared on its device (``prepare_state``), whose result is the
    detection dict of :func:`forward_prepared` stacked on a leading k axis.

    On a CUDA device the k forwards are one CUDA graph
    (:func:`capture_scan`), captured at the first call for (k, B, H, W,
    device) and the state's tensors, and kept in ``fn.graphs``: a call is
    one copy into the graph's static input and one replay, and the result
    is the graph's static output, valid until the next call at that shape.
    Elsewhere the k forwards run in a loop, the plain version."""
    check_config(cfg, mask_format)
    graphs: dict = {}

    def forward(state, x):
        return forward_prepared(state, x, cfg, with_masks, mask_format)

    def fn(state: dict, images) -> dict:
        images = torch.as_tensor(images)
        device = tensor_leaves(state)[0].device
        with torch.inference_mode():
            if device.type != "cuda":
                outs = [forward(state, images[i].to(device))
                        for i in range(images.shape[0])]
                return {k: torch.stack([o[k] for o in outs])
                        for k in outs[0]}
            key = (tuple(images.shape), device)
            graph = graphs.get(key)
            if graph is None or graph.state_key != storage_key(state):
                graphs.pop(key, None)
                graph = capture_scan(lambda x: forward(state, x),
                                     tuple(images.shape), device)
                graph.state_key = storage_key(state)
                graphs[key] = graph
            graph.static_in.copy_(images, non_blocking=True)
            graph.replay()
            return graph.outputs

    fn.graphs = graphs
    return fn


# ---------------------------------------------------------------------------
# initialization: a parameter tree in the reference's schema (the layout its
# init_params and .npz checkpoints share), drawn from a torch.Generator

def _normal(g, shape, std):
    return torch.randn(shape, generator=g) * std


def _uniform(g, shape, lim):
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * lim


def _unit(g, kh, kw, cin, cout):
    # He/MSRA fan-out, FrozenBN scale 1 and bias 0
    return {"w": _normal(g, (kh, kw, cin, cout),
                         math.sqrt(2.0 / (kh * kw * cout))),
            "scale": torch.ones(cout), "bias": torch.zeros(cout)}


def _init_resnet(g, depth=50, stem_out=64, res2_out=256):
    params = {"stem": _unit(g, 7, 7, 3, stem_out)}
    cin, out = stem_out, res2_out
    for si, stage in enumerate(["res2", "res3", "res4", "res5"]):
        mid = out // 4
        blocks = []
        for bi in range(BLOCKS_PER_STAGE[depth][si]):
            bp = {"conv1": _unit(g, 1, 1, cin, mid),
                  "conv2": _unit(g, 3, 3, mid, mid),
                  "conv3": _unit(g, 1, 1, mid, out)}
            # zero-gamma residual branch, as the reference initializes it
            bp["conv3"]["scale"] = torch.zeros(out)
            if bi == 0:
                bp["shortcut"] = _unit(g, 1, 1, cin, out)
            blocks.append(bp)
            cin = out
        params[stage] = blocks
        out *= 2
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random weights in the reference's parameter schema (HWIO convs,
    FrozenBN units {w, scale, bias}, (in, out) linears, (kh, kw, out, in)
    deconv), float32 on the CPU; ``utils.weights.from_jax_params`` turns
    them into the port's state. The distributions follow the reference's
    initializers; the numbers differ (another generator)."""
    g, C = generator, cfg.fpn_channels
    fpn = {}
    for i, cin in enumerate((256, 512, 1024, 2048)):
        fpn[f"lateral{i + 2}"] = {"w": _uniform(g, (1, 1, cin, C),
                                                math.sqrt(6.0 / cin)),
                                  "b": torch.zeros(C)}
        fpn[f"output{i + 2}"] = {"w": _uniform(g, (3, 3, C, C),
                                               math.sqrt(6.0 / (9 * C))),
                                 "b": torch.zeros(C)}
    A = cfg.num_anchors
    rpn = {"conv": {"w": _normal(g, (3, 3, C, C), 0.01), "b": torch.zeros(C)},
           "objectness": {"w": _normal(g, (1, 1, C, A), 0.01),
                          "b": torch.zeros(A)},
           "deltas": {"w": _normal(g, (1, 1, C, 4 * A), 0.01),
                      "b": torch.zeros(4 * A)}}
    flat, fc, K = C * cfg.box_pooler_resolution ** 2, cfg.box_fc_dim, \
        cfg.num_classes
    box = {"fc1": {"w": _uniform(g, (flat, fc), math.sqrt(6.0 / (flat + fc))),
                   "b": torch.zeros(fc)},
           "fc2": {"w": _uniform(g, (fc, fc), math.sqrt(6.0 / (2 * fc))),
                   "b": torch.zeros(fc)},
           "cls": {"w": _normal(g, (fc, K + 1), 0.01), "b": torch.zeros(K + 1)},
           "bbox": {"w": _normal(g, (fc, 4 * K), 0.001),
                    "b": torch.zeros(4 * K)}}
    M = cfg.mask_conv_dim
    mask, cin = {}, C
    for i in range(cfg.mask_num_conv):
        mask[f"conv{i + 1}"] = {"w": _normal(g, (3, 3, cin, M),
                                             math.sqrt(2.0 / (9 * M))),
                                "b": torch.zeros(M)}
        cin = M
    mask["deconv"] = {"w": _normal(g, (2, 2, M, cin),
                                   math.sqrt(2.0 / (4 * cin))),
                      "b": torch.zeros(M)}
    mask["predictor"] = {"w": _normal(g, (1, 1, M, K), math.sqrt(2.0 / K)),
                         "b": torch.zeros(K)}
    return {"backbone": _init_resnet(g), "fpn": fpn, "rpn": rpn,
            "box_head": box, "mask_head": mask}
