"""Learning smoke: train the Mask R-CNN from scratch on synthetic coloured
rectangles and check that the detections find and classify them.

    python -m roadsurf_tpu_torch.tools.learning_smoke [--steps 500]
        [--device cuda]

A port of the reference package's ``scripts/smoke_learning.py``, the
check that the framework learns: the same configuration (the fast profile
with 64 proposals at 64 px, no frozen stages, std-normalised inputs for a
start from scratch, 64 ROIs and 32 anchors sampled an image, 4 detections),
the same solver (base lr 0.005, 100 warm-up steps), the same batches from
``np.random.default_rng(0)`` (16 tiles of two rectangles each, red for
class 0 and green for class 1, on dark noise) and the same scoring of 8
test tiles: a ground-truth box is found when a detection of score >= 0.3
overlaps it at IoU > 0.3, class-correct when the best such detection has
its class. The training runs the port's step (``engine.train.train_step``:
K1 forward and K5 backward on the card, the sweep NMS); the forward that is
scored runs ``forward_inference``. Prints one JSON line and returns the
same dict (the loss curve every 50 steps and at the last).
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import numpy as np
import torch

from ..engine.train import init_train_state, train_step
from ..models.config import ModelConfig, fast_profile
from ..models.mask_rcnn import forward_inference, init_params
from ..pipeline.training import to_device
from ..utils.device import resolve_device
from ..utils.weights import fold_train_params, from_jax_train_params

S, B, G = 64, 16, 2          # tile side, batch, rectangles a tile
TEST_TILES = 8
FOUND_IOU, FOUND_SCORE = 0.3, 0.3
CURVE_KEYS = ("total", "loss_cls", "loss_rpn_cls", "loss_mask")
LOG_EVERY = 50               # the curve's steps, as the script prints them
INIT_SEED, SEED = 0, 7       # the weights' init; the sampling draws


def smoke_config() -> ModelConfig:
    """The smoke's model and solver (``scripts/smoke_learning.py``)."""
    cfg = replace(fast_profile(post_nms_topk=64),
                  min_size_test=S, max_size_test=S,
                  roi_batch_per_image=64, rpn_batch_per_image=32,
                  detections_per_image=4, freeze_at=0,
                  pixel_std=(57.375, 57.12, 58.395))
    return replace(cfg, base_lr=0.005, warmup_iters=100)


def make_batch(rng: np.random.Generator, n: int) -> dict:
    """``n`` tiles of G rectangles (14-27 px sides, class 0 red, class 1
    green) on noise below 60, with their boxes, classes and masks: the
    reference's draws from ``rng``, in its order."""
    imgs = rng.integers(0, 60, (n, S, S, 3), dtype=np.uint8)
    boxes = np.zeros((n, G, 4), np.float32)
    classes = np.zeros((n, G), np.int32)
    valid = np.zeros((n, G), bool)
    masks = np.zeros((n, G, S, S), np.uint8)
    for b in range(n):
        for g in range(G):
            w, h = rng.integers(14, 28, 2)
            x0 = rng.integers(0, S - w)
            y0 = rng.integers(0, S - h)
            cls = int(rng.integers(0, 2))
            color = (220, 60, 60) if cls == 0 else (60, 220, 60)
            imgs[b, y0:y0 + h, x0:x0 + w] = color
            boxes[b, g] = (x0, y0, x0 + w, y0 + h)
            classes[b, g] = cls
            valid[b, g] = True
            masks[b, g, y0:y0 + h, x0:x0 + w] = 1
    return {"image": imgs, "gt_boxes": boxes, "gt_classes": classes,
            "gt_valid": valid, "gt_masks": masks}


def score(out: dict, test: dict) -> dict:
    """Found (IoU > 0.3 with a detection of score >= 0.3), class-correct
    and mean best IoU over the test tiles' ground-truth boxes, as the
    reference scores them."""
    ious, correct, found = [], 0, 0
    n, d_max = out["valid"].shape
    for b in range(n):
        for g in range(test["gt_boxes"].shape[1]):
            gt = test["gt_boxes"][b, g]
            best, bestc = 0.0, -1
            for d in range(d_max):
                if not out["valid"][b, d] \
                        or out["scores"][b, d] < FOUND_SCORE:
                    continue
                db = out["boxes"][b, d]
                xx0, yy0 = max(gt[0], db[0]), max(gt[1], db[1])
                xx1, yy1 = min(gt[2], db[2]), min(gt[3], db[3])
                inter = max(xx1 - xx0, 0) * max(yy1 - yy0, 0)
                u = (gt[2] - gt[0]) * (gt[3] - gt[1]) \
                    + (db[2] - db[0]) * (db[3] - db[1]) - inter
                if inter / u > best:
                    best, bestc = inter / u, int(out["classes"][b, d])
            if best > FOUND_IOU:
                found += 1
                if bestc == test["gt_classes"][b, g]:
                    correct += 1
            ious.append(best)
    return {"found": found, "instances": len(ious),
            "class_correct": correct, "mean_iou": float(np.mean(ious))}


def run(steps: int = 500, device="cuda", learn: bool = True) -> dict:
    """Train ``steps`` steps from the random init of ``INIT_SEED`` on
    batches from ``default_rng(0)``, then score ``TEST_TILES`` tiles drawn
    after them. Without ``learn`` the base lr is 0, so the weights stay at
    their init: the control that the loss curve is read against. Returns
    {"curve": [{step, total, loss_cls, loss_rpn_cls, loss_mask}, ...] every
    ``LOG_EVERY`` steps and at the last, "totals" (every step's total
    loss), "train_s", "found", "instances", "class_correct", "mean_iou",
    "device"}. Raises when ``device`` names CUDA and no CUDA device is
    present."""
    dev = resolve_device(device)
    cfg = smoke_config() if learn else replace(smoke_config(), base_lr=0.0)
    rng = np.random.default_rng(0)
    tree = init_params(cfg, torch.Generator().manual_seed(INIT_SEED))
    state = init_train_state(from_jax_train_params(tree), cfg, seed=SEED,
                             device=dev)
    step = train_step(cfg, S)
    logged = []         # every step's losses, read once training is done
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, to_device(make_batch(rng, B), dev))
        logged.append(torch.stack([m[k] for k in CURVE_KEYS]))
    losses = torch.stack(logged).cpu().numpy() if logged \
        else np.zeros((0, len(CURVE_KEYS)))
    train_s = time.perf_counter() - t0
    curve = [{"step": it, **dict(zip(CURVE_KEYS, map(float, losses[it])))}
             for it in range(steps) if it % LOG_EVERY == 0
             or it == steps - 1]
    test = make_batch(rng, TEST_TILES)
    out = forward_inference(fold_train_params(state["params"]),
                            test["image"], cfg, with_masks=False,
                            device=dev)
    out = {k: v.float().cpu().numpy() if v.is_floating_point()
           else v.cpu().numpy() for k, v in out.items()}
    return {"curve": curve, "totals": [float(v) for v in losses[:, 0]],
            "train_s": train_s, **score(out, test),
            "device": str(dev)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Trains the detector from scratch on synthetic "
                    "rectangles and scores what it finds.")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    res = run(args.steps, args.device)
    res.pop("totals")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
