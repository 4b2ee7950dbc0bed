"""detectron2 -> the reference's parameter tree: checkpoint conversion.

A copy of the reference package's ``utils/d2_convert.py``. The pipeline
runs inference from ``logs/model_0005999.pth`` (config/config_obj_detec.yaml,
``make_detections.py: model_weights``). This maps a detectron2 state dict
(torch ``.pth`` or model-zoo pickle ``.pkl``) onto the reference's
parameter tree, which ``utils.weights.from_jax_params`` turns into the
port's state:

* conv weights OIHW -> HWIO;
* FrozenBatchNorm folded into per-channel (scale, bias):
  scale = γ/√(σ²+ε), bias = β − μ·scale (ε = 1e-5);
* linear weights (out, in) -> (in, out); box FC1's input rows permuted from
  detectron2's (c, p, q) flattening to the box head's (p, q, c);
* ConvTranspose2d weights (in, out, kh, kw) -> (kh, kw, out, in);
* sub-modules absent from the checkpoint are pruned (reported), and
  ``merge_params`` skips head weights whose class count differs (a COCO-80
  zoo checkpoint on the 2-class road model), detectron2-style warm start.
"""

from __future__ import annotations

import logging
import pickle

import numpy as np
import torch

logger = logging.getLogger(__name__)

_BN_EPS = 1e-5


def _load_state_dict(path: str) -> dict:
    if path.endswith(".pkl"):
        # a model-zoo pickle: only files this pipeline was pointed at
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        sd = data.get("model", data)
        return {k: np.asarray(v) for k, v in sd.items()
                if isinstance(v, np.ndarray) or hasattr(v, "shape")}
    data = torch.load(path, map_location="cpu", weights_only=True)
    sd = data.get("model", data) if isinstance(data, dict) else data
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _conv_unit(sd: dict, base: str) -> dict | None:
    """conv + FrozenBN unit at detectron2 key prefix ``base``."""
    wk = f"{base}.weight"
    if wk not in sd:
        return None
    w = np.transpose(sd[wk], (2, 3, 1, 0))  # OIHW -> HWIO
    gamma = sd[f"{base}.norm.weight"]
    beta = sd[f"{base}.norm.bias"]
    mean = sd[f"{base}.norm.running_mean"]
    var = sd[f"{base}.norm.running_var"]
    scale = gamma / np.sqrt(var + _BN_EPS)
    return {"w": w.astype(np.float32), "scale": scale.astype(np.float32),
            "bias": (beta - mean * scale).astype(np.float32)}


def _conv_b(sd: dict, base: str) -> dict | None:
    wk = f"{base}.weight"
    if wk not in sd:
        return None
    return {"w": np.transpose(sd[wk], (2, 3, 1, 0)).astype(np.float32),
            "b": sd[f"{base}.bias"].astype(np.float32)}


def _linear(sd: dict, base: str) -> dict | None:
    wk = f"{base}.weight"
    if wk not in sd:
        return None
    return {"w": np.transpose(sd[wk], (1, 0)).astype(np.float32),
            "b": sd[f"{base}.bias"].astype(np.float32)}


def _linear_from_pooled(sd: dict, base: str, pool: int) -> dict | None:
    """FC consuming flattened RoI features: detectron2 flattens NCHW
    (c, p, q) while the box head flattens NHWC (p, q, c) — permute the
    weight's input dimension accordingly."""
    wk = f"{base}.weight"
    if wk not in sd:
        return None
    w = sd[wk]                                   # (out, C*pool*pool), (c,p,q)
    out_dim, in_dim = w.shape
    ch = in_dim // (pool * pool)
    w = w.reshape(out_dim, ch, pool, pool)
    w = np.transpose(w, (2, 3, 1, 0)).reshape(in_dim, out_dim)   # (p,q,c)
    return {"w": w.astype(np.float32),
            "b": sd[f"{base}.bias"].astype(np.float32)}


def load_detectron2_checkpoint(path: str, blocks=(3, 4, 6, 3)) -> dict:
    """Convert a detectron2 Mask R-CNN R50-FPN checkpoint into the
    reference's parameter tree ({backbone, fpn, rpn, box_head,
    mask_head})."""
    sd = _load_state_dict(path)
    # model-zoo pickles use 'backbone.bottom_up.*'; plain backbones 'backbone.*'
    bb = "backbone.bottom_up" if any(
        k.startswith("backbone.bottom_up") for k in sd) else "backbone"

    backbone: dict = {"stem": _conv_unit(sd, f"{bb}.stem.conv1")}
    for si, stage in enumerate(["res2", "res3", "res4", "res5"]):
        stage_params = []
        for bi in range(blocks[si]):
            base = f"{bb}.{stage}.{bi}"
            bp = {
                "conv1": _conv_unit(sd, f"{base}.conv1"),
                "conv2": _conv_unit(sd, f"{base}.conv2"),
                "conv3": _conv_unit(sd, f"{base}.conv3"),
            }
            sc = _conv_unit(sd, f"{base}.shortcut")
            if sc is not None:
                bp["shortcut"] = sc
            stage_params.append(bp)
        backbone[stage] = stage_params

    fpn = {}
    for lvl in range(2, 6):
        fpn[f"lateral{lvl}"] = _conv_b(sd, f"backbone.fpn_lateral{lvl}")
        fpn[f"output{lvl}"] = _conv_b(sd, f"backbone.fpn_output{lvl}")

    rpn = {
        "conv": _conv_b(sd, "proposal_generator.rpn_head.conv"),
        "objectness": _conv_b(
            sd, "proposal_generator.rpn_head.objectness_logits"),
        "deltas": _conv_b(sd, "proposal_generator.rpn_head.anchor_deltas"),
    }

    box_head = {
        "fc1": _linear_from_pooled(sd, "roi_heads.box_head.fc1", pool=7),
        "fc2": _linear(sd, "roi_heads.box_head.fc2"),
        "cls": _linear(sd, "roi_heads.box_predictor.cls_score"),
        "bbox": _linear(sd, "roi_heads.box_predictor.bbox_pred"),
    }

    mask_head = {}
    for i in range(1, 5):
        mask_head[f"conv{i}"] = _conv_b(sd, f"roi_heads.mask_head.mask_fcn{i}")
    dk = "roi_heads.mask_head.deconv.weight"
    if dk in sd:
        # ConvTranspose2d (in, out, kh, kw) -> (kh, kw, out, in), the
        # reference's deconv layout (from_jax_params moves it back)
        mask_head["deconv"] = {
            "w": np.transpose(sd[dk], (2, 3, 1, 0)).astype(np.float32),
            "b": sd["roi_heads.mask_head.deconv.bias"].astype(np.float32)}
    mask_head["predictor"] = _conv_b(sd, "roi_heads.mask_head.predictor")

    tree = {"backbone": backbone, "fpn": fpn, "rpn": rpn,
            "box_head": box_head, "mask_head": mask_head}
    missing = _prune_missing(tree)
    if missing:
        logger.warning(f"detectron2 checkpoint: {len(missing)} sub-modules "
                       f"absent in {path} (kept random init): "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}")
    return tree


def _prune_missing(tree, prefix="") -> list[str]:
    """Remove None leaves (absent in source checkpoint); report their paths."""
    missing = []
    if isinstance(tree, dict):
        for k in list(tree.keys()):
            sub = tree[k]
            p = f"{prefix}{k}"
            if sub is None:
                missing.append(p)
                del tree[k]
            else:
                missing.extend(_prune_missing(sub, p + "/"))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            missing.extend(_prune_missing(sub, f"{prefix}{i}/"))
    return missing


def merge_params(init_tree: dict, loaded: dict, _path="") -> tuple[dict, list]:
    """Overlay ``loaded`` onto ``init_tree`` where shapes agree; returns the
    merged tree and the list of skipped (shape-mismatch) paths."""
    skipped = []

    def rec(dst, src, path):
        if isinstance(dst, dict) and isinstance(src, dict):
            out = {}
            for k, v in dst.items():
                if k in src:
                    out[k] = rec(v, src[k], f"{path}{k}/")
                else:
                    out[k] = v
            return out
        if isinstance(dst, list) and isinstance(src, list):
            return [rec(d, s, f"{path}{i}/")
                    for i, (d, s) in enumerate(zip(dst, src))]
        if hasattr(dst, "shape") and hasattr(src, "shape"):
            if tuple(dst.shape) == tuple(src.shape):
                return np.asarray(src)
            skipped.append(path[:-1])
            return dst
        return dst

    merged = rec(init_tree, loaded, _path)
    if skipped:
        logger.warning(f"checkpoint merge: {len(skipped)} tensors skipped on "
                       f"shape mismatch (class-count heads): {skipped}")
    return merged, skipped
