"""Per-branch cost of the training step: the gradients of cumulative loss
subsets, so that each row's marginal is a branch's forward and backward.

    python -m roadsurf_tpu_torch.tools.profile_training [--device cuda]

A port of the reference package's ``scripts/profile_training.py``: the
fast profile with the reference's training budgets (2000/1000 RPN
proposals, 1024 ROIs and 256 anchors an image) and ``BENCH_CHUNKS``
(``train_head_chunks``, 1) and ``BENCH_REMAT`` (``train_remat``, 0), at
``BENCH_BATCH`` 8 and 256 px, ``BENCH_STEPS`` 4; weights from
``init_params`` seeded 0; ``steps + 1`` distinct batches (8 boxes an
image, random masks, ``default_rng(0)``) on the device before the clock
starts; one set of sampling uniforms for every step, as the script keeps
one key (``PRNGKey(3)``; drawn here from a ``torch.Generator`` seeded 3).
The rows: the RPN's losses (backbone, FPN and RPN, forward and backward),
then with the box head's, then the mask branch's (FULL). A step is the
subset's losses (``engine.train.compute_losses``) and their gradients
with respect to the trainable parameters, reduced to one scalar (the sum
of every gradient's |g|, fetched).

Prints the script's table (ms/step, marginal, TFLOP; FlopCounterMode's
count of one step: convolutions and matrix products only) with the event
ms, and one JSON line a row (``bench_common``).
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import numpy as np
import torch

from ..engine.train import _trainable, compute_losses, draw_uniforms, \
    init_train_state
from ..models.config import ModelConfig, fast_profile
from ..models.mask_rcnn import init_params
from ..utils.weights import from_jax_train_params
from ..utils.device import resolve_device
from .bench_common import FLOPS_COUNTED, card, emit, flop_count, \
    time_steps

SUBSETS = (
    ("rpn only (bb+fpn+rpn fwd+bwd)", ("loss_rpn_cls", "loss_rpn_loc")),
    ("+box head", ("loss_rpn_cls", "loss_rpn_loc", "loss_cls",
                   "loss_box_reg")),
    ("+mask branch = FULL", ("loss_rpn_cls", "loss_rpn_loc", "loss_cls",
                             "loss_box_reg", "loss_mask")),
)
SIZE = 256
GT = 8                          # instances an image
DRAW_SEED = 3


def settings(env=None) -> dict:
    """The script's knobs: {cfg, batch, steps}."""
    env = os.environ if env is None else env
    cfg = replace(fast_profile(),
                  rpn_pre_nms_topk_train=2000, rpn_post_nms_topk_train=1000,
                  roi_batch_per_image=1024, rpn_batch_per_image=256,
                  train_head_chunks=int(env.get("BENCH_CHUNKS", "1")),
                  train_remat=env.get("BENCH_REMAT", "0") == "1")
    return {"cfg": cfg, "batch": int(env.get("BENCH_BATCH", "8")),
            "steps": int(env.get("BENCH_STEPS", "4"))}


def make_batch(rng, B: int, S: int = SIZE, g: int = GT) -> dict:
    """The script's batch: ``g`` boxes an image, random masks (numpy)."""
    boxes = rng.uniform(8, 200, (B, g, 4)).astype(np.float32)
    boxes = np.stack([np.minimum(boxes[..., 0], boxes[..., 2]),
                      np.minimum(boxes[..., 1], boxes[..., 3]),
                      np.maximum(boxes[..., 0], boxes[..., 2]) + 16,
                      np.maximum(boxes[..., 1], boxes[..., 3]) + 16], -1)
    return {"image": rng.integers(0, 255, (B, S, S, 3), np.uint8),
            "gt_boxes": boxes.astype(np.float32),
            "gt_classes": rng.integers(0, 2, (B, g)).astype(np.int32),
            "gt_valid": np.ones((B, g), bool),
            "gt_masks": rng.integers(0, 2, (B, g, S, S)).astype(np.uint8)}


def to_device(batch: dict, dev) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in batch.items()}
    out["gt_classes"] = out["gt_classes"].long()
    return out


def subset_loss(params: dict, batch: dict, draws: dict, cfg: ModelConfig,
                keys, S: int = SIZE) -> torch.Tensor:
    """The sum of the losses ``keys`` of one batch."""
    losses = compute_losses(params, batch, draws, cfg, S)
    return sum(losses[k] for k in keys)


def gradient_fn(state: dict, draws: dict, cfg: ModelConfig, keys,
                S: int = SIZE):
    """``fn(batch)``: the gradients of a subset's loss, each reduced to
    the sum of its |g| (the script's per-leaf reduction; a parameter the
    subset does not reach has a zero gradient, as ``jax.grad`` gives it)."""
    ps, _ = _trainable(state, cfg)

    def fn(batch):
        loss = subset_loss(state["params"], batch, draws, cfg, keys, S)
        grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                    materialize_grads=True)
        return [g.float().abs().sum() for g in grads]
    return fn


def run(env=None, device="cuda", cfg: ModelConfig | None = None,
        batch: int | None = None, steps: int | None = None,
        size: int = SIZE, params: dict | None = None) -> list:
    """The profile at the knobs of ``env`` (default: the process's);
    ``cfg``, ``batch``, ``steps``, the tiles' side and the train-state
    parameters override them. Returns the rows."""
    dev = resolve_device(device)
    s = settings(env)
    cfg = cfg or s["cfg"]
    B = batch or s["batch"]
    steps = steps or s["steps"]
    params = params if params is not None else from_jax_train_params(
        init_params(cfg, torch.Generator().manual_seed(0)))
    state = init_train_state(params, cfg, device=dev)
    rng = np.random.default_rng(0)
    batches = [(to_device(make_batch(rng, B, size), dev),)
               for _ in range(steps + 1)]
    gen = torch.Generator(device=dev).manual_seed(DRAW_SEED)
    draws = draw_uniforms(cfg, size, B, GT, gen)
    print(f"batch={B} chunks={cfg.train_head_chunks} "
          f"remat={cfg.train_remat}", file=sys.stderr)
    rows, prev = [], 0.0
    for name, keys in SUBSETS:
        fn = gradient_fn(state, draws, cfg, keys, size)
        tflop = flop_count(fn, *batches[0]) / 1e12
        t = time_steps(fn, batches)
        row = {"branch": name, "ms_per_step": t["ms"],
               "event_ms_per_step": t["event_ms"],
               "marginal_ms": t["ms"] - prev, "tflop": tflop,
               "scalar": t["scalar"], "batch": B, "steps": steps,
               "flops": FLOPS_COUNTED, "card": card(dev)}
        prev = t["ms"]
        rows.append(row)
        emit(row)
    print("\nbranch                           ms/step  marginal_ms  TFLOP"
          "  event_ms")
    for r in rows:
        ev = r["event_ms_per_step"]
        print(f"{r['branch']:32s} {r['ms_per_step']:9.2f} "
              f"{r['marginal_ms']:11.2f} {r['tflop']:7.2f} "
              f"{'' if ev is None else f'{ev:9.2f}'}")
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Per-branch forward+backward cost of the training step "
                    "(knobs: BENCH_BATCH, BENCH_STEPS, BENCH_CHUNKS, "
                    "BENCH_REMAT).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
