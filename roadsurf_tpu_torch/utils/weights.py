"""Weight bridge: the reference's parameter tree -> the port's state.

The reference keeps its parameters as nested dicts and lists of arrays
(its ``init_params`` and its ``.npz`` checkpoints, which ``load_params``
reads and ``save_params`` writes; ``load_params`` also converts a
detectron2 ``.pth``/``.pkl`` into such a tree, as the reference's does).
:func:`from_jax_params` turns such a tree, given as numpy arrays,
into the port's state — the same nesting, with torch-layout tensors:

* conv ``w`` HWIO -> OIHW; a FrozenBN unit ``{w, scale, bias}`` becomes
  ``{w: w·scale per output channel, b: bias}`` (folded in float32, as the
  reference folds it);
* linear ``w`` (in, out) -> (out, in). fc1's input rows stay in the
  reference's (p, q, c) order: the box head flattens pooled features NHWC;
* the mask deconv ``w`` (kh, kw, out, in) -> the ``ConvTranspose2d``
  layout (in, out, kh, kw), ``w.transpose(3, 2, 0, 1)``. With in == out
  a wrong permutation still has the right shape, so a test pins it.

The static-int8 groups that the reference's ``models/quant.py`` calibrates
(``params["quant"]``, or the legacy ``params["backbone_q"]``) become the
port's quant state (:func:`from_jax_quant`): each unit ``{wq, mult, bias,
sa}`` keeps ``wq`` int8 in the torch layout of its float twin (conv HWIO ->
OIHW, deconv (kh, kw, out, in) -> (in, out, kh, kw), linear (in, out) ->
(out, in)) and ``mult``, ``bias``, ``sa`` and the ``pyr`` arrays float32;
the uint8-direct stem's bias map (S/2, S/2, C) becomes (1, C, S/2, S/2),
which adds to an NCHW (channels_last) conv output.

Every leaf of the tree must be consumed; anything left over raises.

Training keeps a **train state** instead (:func:`from_jax_train_params`):
the same layouts, float32 master tensors, with each backbone unit kept
unfolded as ``{w: OIHW, scale, bias}`` so that ``w`` trains while the
FrozenBN ``scale`` and ``bias`` stay fixed; :func:`to_jax_params` gives
back the reference's schema (what ``.npz`` checkpoints hold), and
:func:`fold_train_params` the inference state that :func:`from_jax_params`
builds from the same tree, bit for bit.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch


def _flatten(tree, prefix="") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_params(path: str, tree, step: int | None = None) -> str:
    """Save a tree of arrays (numpy, or CPU tensors) as the shared ``.npz``
    format, flat arrays keyed "a/b/c" (creating parent dirs)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)
    return path


def load_params(path: str):
    """Load a checkpoint -> (tree, step): a native ``.npz`` (flat arrays
    keyed "a/b/c"), or a detectron2 ``.pth``/``.pkl`` converted on the fly
    (``utils/d2_convert.py``; step None)."""
    if path.endswith((".pth", ".pkl")):
        from .d2_convert import load_detectron2_checkpoint
        return load_detectron2_checkpoint(path), None
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    step = None
    if "__step__" in flat:
        step = int(flat.pop("__step__"))
    return _unflatten(flat), step


class _Leaves:
    """The tree's leaves by path; each is taken at most once."""

    def __init__(self, tree):
        self.flat = _flatten(tree)

    def has(self, path: str) -> bool:
        return path in self.flat

    def take(self, path: str, dtype=np.float32) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"parameter {path!r} missing from the tree")
        return np.asarray(self.flat.pop(path), dtype)

    def done(self):
        if self.flat:
            raise ValueError("parameters not consumed by the port: "
                             + ", ".join(sorted(self.flat)))


def _t(a: np.ndarray, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype, order="C"))


def _conv_bn(lv: _Leaves, base: str) -> dict:
    w = lv.take(f"{base}/w") * lv.take(f"{base}/scale")
    return {"w": _t(w.transpose(3, 2, 0, 1)), "b": _t(lv.take(f"{base}/bias"))}


def _conv_b(lv: _Leaves, base: str) -> dict:
    return {"w": _t(lv.take(f"{base}/w").transpose(3, 2, 0, 1)),
            "b": _t(lv.take(f"{base}/b"))}


def _linear(lv: _Leaves, base: str) -> dict:
    return {"w": _t(lv.take(f"{base}/w").T), "b": _t(lv.take(f"{base}/b"))}


# int8 weight layouts: reference -> torch (the float twins' moves)
_QLAYOUT = {"conv": (3, 2, 0, 1), "deconv": (3, 2, 0, 1), "linear": (1, 0)}


def _qunit(lv: _Leaves, base: str, layout: str) -> dict:
    """One calibrated unit {wq, mult, bias, sa}: wq int8 in the torch
    layout, the rest float32. A bias map (the uint8-direct stem's, (h, w,
    C)) becomes (1, C, h, w)."""
    bias = lv.take(f"{base}/bias")
    if bias.ndim == 3:
        bias = bias.transpose(2, 0, 1)[None]
    return {"wq": _t(lv.take(f"{base}/wq", np.int8).transpose(
                _QLAYOUT[layout]), np.int8),
            "mult": _t(lv.take(f"{base}/mult")), "bias": _t(bias),
            "sa": _t(lv.take(f"{base}/sa"))}


def _qbackbone(lv: _Leaves, base: str) -> dict:
    q = {"stem": _qunit(lv, f"{base}/stem", "conv")}
    if lv.has(f"{base}/stem_u8/wq"):
        q["stem_u8"] = _qunit(lv, f"{base}/stem_u8", "conv")
    for stage in ("res2", "res3", "res4", "res5"):
        blocks, i = [], 0
        while lv.has(f"{base}/{stage}/{i}/conv1/wq"):
            blocks.append({n: _qunit(lv, f"{base}/{stage}/{i}/{n}", "conv")
                           for n in ("conv1", "conv2", "conv3", "shortcut")
                           if lv.has(f"{base}/{stage}/{i}/{n}/wq")})
            i += 1
        q[stage] = blocks
    return q


def _quant(lv: _Leaves, base: str) -> dict:
    """The groups of a ``quant`` tree that are present (the reference's
    ``prepare_quantized`` returns those of its scope)."""
    q = {}
    if lv.has(f"{base}/backbone/stem/wq"):
        q["backbone"] = _qbackbone(lv, f"{base}/backbone")
    if lv.has(f"{base}/fpn/lateral2/wq"):
        q["fpn"] = {f"{kind}{i}": _qunit(lv, f"{base}/fpn/{kind}{i}", "conv")
                    for i in range(2, 6) for kind in ("lateral", "output")}
    if lv.has(f"{base}/rpn/conv/wq"):
        q["rpn"] = {n: _qunit(lv, f"{base}/rpn/{n}", "conv")
                    for n in ("conv", "objectness", "deltas")}
    if lv.has(f"{base}/pyr/out_sa"):
        q["pyr"] = {n: _t(lv.take(f"{base}/pyr/{n}"))
                    for n in ("out_sa", "res_sa", "rpn_mult", "lat_sa")
                    if lv.has(f"{base}/pyr/{n}")}
    if lv.has(f"{base}/box/fc1/wq"):
        q["box"] = {n: _qunit(lv, f"{base}/box/{n}", "linear")
                    for n in ("fc1", "fc2")}
    if lv.has(f"{base}/mask/conv1/wq"):
        mask, i = {}, 1
        while lv.has(f"{base}/mask/conv{i}/wq"):
            mask[f"conv{i}"] = _qunit(lv, f"{base}/mask/conv{i}", "conv")
            i += 1
        if lv.has(f"{base}/mask/deconv/wq"):
            mask["deconv"] = _qunit(lv, f"{base}/mask/deconv", "deconv")
        if lv.has(f"{base}/mask/predictor/wq"):
            mask["predictor"] = _qunit(lv, f"{base}/mask/predictor", "conv")
        q["mask"] = mask
    return q


def from_jax_quant(tree) -> dict:
    """The reference's ``params["quant"]`` (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's quant state of CPU tensors. Every
    leaf must be consumed."""
    lv = _Leaves({"quant": tree})
    q = _quant(lv, "quant")
    lv.done()
    return q


def _backbone(lv: _Leaves, unit) -> dict:
    """The backbone's units, each ``unit(lv, base)``."""
    backbone = {"stem": unit(lv, "backbone/stem")}
    for stage in ("res2", "res3", "res4", "res5"):
        blocks, i = [], 0
        while lv.has(f"backbone/{stage}/{i}/conv1/w"):
            base = f"backbone/{stage}/{i}"
            blocks.append({n: unit(lv, f"{base}/{n}")
                           for n in ("conv1", "conv2", "conv3", "shortcut")
                           if lv.has(f"{base}/{n}/w")})
            i += 1
        backbone[stage] = blocks
    return backbone


def _heads(lv: _Leaves) -> dict:
    """FPN, RPN head, box head and mask head, in the torch layouts."""
    mask, i = {}, 1
    while lv.has(f"mask_head/conv{i}/w"):
        mask[f"conv{i}"] = _conv_b(lv, f"mask_head/conv{i}")
        i += 1
    mask["deconv"] = {"w": _t(lv.take("mask_head/deconv/w")
                              .transpose(3, 2, 0, 1)),
                      "b": _t(lv.take("mask_head/deconv/b"))}
    mask["predictor"] = _conv_b(lv, "mask_head/predictor")
    return {"fpn": {f"{kind}{i}": _conv_b(lv, f"fpn/{kind}{i}")
                    for i in range(2, 6) for kind in ("lateral", "output")},
            "rpn": {n: _conv_b(lv, f"rpn/{n}")
                    for n in ("conv", "objectness", "deltas")},
            "box_head": {n: _linear(lv, f"box_head/{n}")
                         for n in ("fc1", "fc2", "cls", "bbox")},
            "mask_head": mask}


def from_jax_params(tree) -> dict:
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's state of float32 CPU tensors, with
    its int8 groups (``quant``, ``backbone_q``) where the tree has them."""
    lv = _Leaves(tree)
    state = {"backbone": _backbone(lv, _conv_bn), **_heads(lv)}
    quant = _quant(lv, "quant")
    if quant:
        state["quant"] = quant
    if lv.has("backbone_q/stem/wq"):
        state["backbone_q"] = _qbackbone(lv, "backbone_q")
    lv.done()
    return state


def _unit(lv: _Leaves, base: str) -> dict:
    """A FrozenBN unit of the train state: OIHW ``w``, ``scale``, ``bias``,
    unfolded."""
    return {"w": _t(lv.take(f"{base}/w").transpose(3, 2, 0, 1)),
            "scale": _t(lv.take(f"{base}/scale")),
            "bias": _t(lv.take(f"{base}/bias"))}


def from_jax_train_params(tree) -> dict:
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's train state of float32 CPU
    tensors: :func:`from_jax_params`'s layouts with the backbone's units
    unfolded (:func:`_unit`). Every leaf must be consumed; int8 groups are
    refused (training runs none, as in the reference)."""
    lv = _Leaves(tree)
    state = {"backbone": _backbone(lv, _unit), **_heads(lv)}
    lv.done()
    return state


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def to_jax_params(params: dict) -> dict:
    """The inverse of :func:`from_jax_train_params`: the reference's schema
    (HWIO convs, (in, out) linears, (kh, kw, out, in) deconv) as float32
    numpy arrays, the tree ``save_params`` writes."""
    def conv(p):
        return {k: _np(v).transpose(2, 3, 1, 0) if k == "w" else _np(v)
                for k, v in p.items()}

    bb = params["backbone"]
    backbone = {"stem": conv(bb["stem"])}
    for stage in ("res2", "res3", "res4", "res5"):
        backbone[stage] = [{n: conv(u) for n, u in bp.items()}
                           for bp in bb[stage]]
    return {"backbone": backbone,
            "fpn": {n: conv(u) for n, u in params["fpn"].items()},
            "rpn": {n: conv(u) for n, u in params["rpn"].items()},
            "box_head": {n: {"w": _np(u["w"]).T, "b": _np(u["b"])}
                         for n, u in params["box_head"].items()},
            # the deconv's (in, out, kh, kw) goes back to (kh, kw, out, in)
            # by the convs' permutation
            "mask_head": {n: conv(u)
                          for n, u in params["mask_head"].items()}}


def fold_unit(p: dict) -> dict:
    """A FrozenBN unit folded as :func:`from_jax_params` folds it: ``{w:
    w·scale per output channel, b: bias}``, float32 (differentiable in
    ``w``)."""
    return {"w": p["w"] * p["scale"][:, None, None, None], "b": p["bias"]}


def fold_train_params(params: dict) -> dict:
    """The train state's parameters -> the inference state (the layout of
    :func:`from_jax_params`, float32, on their device, without gradient)."""
    with torch.no_grad():
        bb = params["backbone"]
        backbone = {"stem": fold_unit(bb["stem"])}
        for stage in ("res2", "res3", "res4", "res5"):
            backbone[stage] = [{n: fold_unit(u) for n, u in bp.items()}
                               for bp in bb[stage]]

        def plain(tree):
            if isinstance(tree, dict):
                return {k: plain(v) for k, v in tree.items()}
            return tree.detach()

        return {"backbone": backbone,
                **{k: plain(params[k])
                   for k in ("fpn", "rpn", "box_head", "mask_head")}}


def latest_checkpoint(log_dir: str, prefix: str = "model_") -> str | None:
    """The newest ``{prefix}<step>.npz`` in ``log_dir`` (highest step), or
    None (the reference's ``utils/checkpoint.py:latest_checkpoint``)."""
    if not os.path.isdir(log_dir):
        return None
    best, best_step = None, -1
    for f in os.listdir(log_dir):
        m = re.fullmatch(rf"{prefix}(\d+)\.npz", f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(log_dir, f), int(m.group(1))
    return best


# groups of the state placed on the device with their own dtypes (int8
# weights, float32 scales); every other tensor takes the compute dtype
QUANT_GROUPS = ("quant", "backbone_q")


def _place(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _place(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(v, device, dtype) for v in tree]
    t = tree.to(device=device, dtype=dtype or tree.dtype)
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def state_to(state: dict, device, dtype) -> dict:
    """Every tensor of the state on ``device``, convs in channels_last
    memory: the float parameters in ``dtype``, the int8 groups
    (``QUANT_GROUPS``) in their own dtypes, so that ``mult`` and the scales
    stay float32. Tensors already there are returned as they are, so a
    prepared state passes through at the cost of a tree walk."""
    return {k: _place(v, device, None if k in QUANT_GROUPS else dtype)
            for k, v in state.items()}
