"""Weight bridge: the reference's parameter tree -> the port's state.

The reference keeps its parameters as nested dicts and lists of arrays
(its ``init_params`` and its ``.npz`` checkpoints, which ``load_params``
reads). :func:`from_jax_params` turns such a tree, given as numpy arrays,
into the port's state — the same nesting, with torch-layout tensors:

* conv ``w`` HWIO -> OIHW; a FrozenBN unit ``{w, scale, bias}`` becomes
  ``{w: w·scale per output channel, b: bias}`` (folded in float32, as the
  reference folds it);
* linear ``w`` (in, out) -> (out, in). fc1's input rows stay in the
  reference's (p, q, c) order: the box head flattens pooled features NHWC;
* the mask deconv ``w`` (kh, kw, out, in) -> the ``ConvTranspose2d``
  layout (in, out, kh, kw), ``w.transpose(3, 2, 0, 1)``. With in == out
  a wrong permutation still has the right shape, so a test pins it.

Every leaf of the tree must be consumed; anything left over (e.g. the
int8 groups ``quant``/``backbone_q``) raises.
"""

from __future__ import annotations

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


def load_params(path: str):
    """Load a native ``.npz`` checkpoint (flat arrays keyed "a/b/c") ->
    (tree, step)."""
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

    def take(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"parameter {path!r} missing from the tree")
        return np.asarray(self.flat.pop(path), np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _conv_bn(lv: _Leaves, base: str) -> dict:
    w = lv.take(f"{base}/w") * lv.take(f"{base}/scale")
    return {"w": _t(w.transpose(3, 2, 0, 1)), "b": _t(lv.take(f"{base}/bias"))}


def _conv_b(lv: _Leaves, base: str) -> dict:
    return {"w": _t(lv.take(f"{base}/w").transpose(3, 2, 0, 1)),
            "b": _t(lv.take(f"{base}/b"))}


def _linear(lv: _Leaves, base: str) -> dict:
    return {"w": _t(lv.take(f"{base}/w").T), "b": _t(lv.take(f"{base}/b"))}


def from_jax_params(tree) -> dict:
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's state of float32 CPU tensors."""
    lv = _Leaves(tree)
    backbone = {"stem": _conv_bn(lv, "backbone/stem")}
    for stage in ("res2", "res3", "res4", "res5"):
        blocks, i = [], 0
        while lv.has(f"backbone/{stage}/{i}/conv1/w"):
            base = f"backbone/{stage}/{i}"
            bp = {n: _conv_bn(lv, f"{base}/{n}")
                  for n in ("conv1", "conv2", "conv3")}
            if lv.has(f"{base}/shortcut/w"):
                bp["shortcut"] = _conv_bn(lv, f"{base}/shortcut")
            blocks.append(bp)
            i += 1
        backbone[stage] = blocks
    fpn = {f"{kind}{i}": _conv_b(lv, f"fpn/{kind}{i}")
           for i in range(2, 6) for kind in ("lateral", "output")}
    rpn = {n: _conv_b(lv, f"rpn/{n}")
           for n in ("conv", "objectness", "deltas")}
    box = {n: _linear(lv, f"box_head/{n}")
           for n in ("fc1", "fc2", "cls", "bbox")}
    mask, i = {}, 1
    while lv.has(f"mask_head/conv{i}/w"):
        mask[f"conv{i}"] = _conv_b(lv, f"mask_head/conv{i}")
        i += 1
    mask["deconv"] = {"w": _t(lv.take("mask_head/deconv/w")
                              .transpose(3, 2, 0, 1)),
                      "b": _t(lv.take("mask_head/deconv/b"))}
    mask["predictor"] = _conv_b(lv, "mask_head/predictor")
    if lv.flat:
        raise ValueError("parameters not consumed by the port: "
                         + ", ".join(sorted(lv.flat)))
    return {"backbone": backbone, "fpn": fpn, "rpn": rpn,
            "box_head": box, "mask_head": mask}


def state_to(state, device, dtype):
    """Every tensor of the state on ``device`` in ``dtype``, convs in
    channels_last memory. Tensors already there are returned as they are,
    so a prepared state passes through at the cost of a tree walk."""
    if isinstance(state, dict):
        return {k: state_to(v, device, dtype) for k, v in state.items()}
    if isinstance(state, list):
        return [state_to(v, device, dtype) for v in state]
    t = state.to(device=device, dtype=dtype)
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t
