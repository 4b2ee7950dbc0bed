"""Training-step throughput and MFU.

    python -m roadsurf_tpu_torch.tools.bench_training [--device cuda]

A port of the reference package's ``scripts/bench_training.py``: the SGD
step end to end (forward, losses, backward, update) of ``ModelConfig()``
(the reference's solver and sampling budgets) at ``BENCH_TRAIN_SIZE``
(256) px for each batch of ``BENCH_TRAIN_BATCHES`` (8,64); above B=16
with ``train_remat`` and ``train_head_chunks = B // 8``. ``BENCH_STEPS``
(4) timed dispatches after a warm-up one, each running
``BENCH_TRAIN_SCANK`` steps (default 4 at B ≤ 16, 1 above): k > 1 through
``engine.train.make_train_scan_step`` (one CUDA graph of k steps on the
card), 1 through ``make_train_step``. Every dispatch gets batches of its
own (:func:`synth_batch`, the script's random tiles with 1-3 box and mask
instances, ``default_rng(0)``), staged on the device before the clock
starts; the loss of each dispatch is fetched to force its completion.

The JSON line a batch keeps the script's keys (``metric``, ``batch``,
``image_size``, ``scan_k``, ``steps_per_sec``, ``tiles_per_sec``,
``step_ms``, ``gflop_per_step``, ``mfu``), unrounded, with the event ms a
step beside the host's. ``gflop_per_step`` is ``FlopCounterMode``'s count
of one eager step (convolutions and matrix products, forward and
backward; not the poolers' kernels or the NMS), and ``mfu`` that count
times steps/s over the H100 SXM's dense bf16 peak, 989 TFLOP/s (the
script's 197e12 is a TPU's).
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import numpy as np
import torch

from ..engine.train import _clone_state, init_train_state, \
    make_train_scan_step, make_train_step
from ..models.config import ModelConfig
from ..models.mask_rcnn import init_params
from ..utils.weights import from_jax_train_params
from ..utils.device import resolve_device
from .bench_common import BF16_PEAK, FLOPS_COUNTED, PEAKS, card, \
    emit, flop_count

KEYS = ("metric", "batch", "image_size", "scan_k", "steps_per_sec",
        "tiles_per_sec", "step_ms", "gflop_per_step", "mfu")


def synth_batch(rng, batch: int, size: int, max_instances: int = 16):
    """Random tiles with a few box+mask instances each (shapes identical
    to the COCO tile loader's output): the script's draws."""
    imgs = rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((batch, max_instances, 4), np.float32)
    classes = np.zeros((batch, max_instances), np.int32)
    valid = np.zeros((batch, max_instances), bool)
    masks = np.zeros((batch, max_instances, size, size), np.uint8)
    for b in range(batch):
        n = int(rng.integers(1, 4))
        for g in range(n):
            x0, y0 = rng.uniform(0, size * 0.6, 2)
            w, h = rng.uniform(size * 0.15, size * 0.4, 2)
            x1, y1 = min(x0 + w, size - 1), min(y0 + h, size - 1)
            boxes[b, g] = (x0, y0, x1, y1)
            classes[b, g] = int(rng.integers(0, 2))
            valid[b, g] = True
            masks[b, g, int(y0):int(y1), int(x0):int(x1)] = 1
    return {"image": imgs, "gt_boxes": boxes, "gt_classes": classes,
            "gt_valid": valid, "gt_masks": masks}


def settings(env=None) -> dict:
    """The script's knobs: {steps, batches, size, runs: [(cfg, batch,
    label, scan_k)]}."""
    env = os.environ if env is None else env
    steps = int(env.get("BENCH_STEPS", "4"))
    batches = [int(b) for b in
               env.get("BENCH_TRAIN_BATCHES", "8,64").split(",")]
    size = int(env.get("BENCH_TRAIN_SIZE", "256"))
    cfg = ModelConfig()
    runs = []
    for batch in batches:
        c = (replace(cfg, train_remat=True,
                     train_head_chunks=max(1, batch // 8))
             if batch > 16 else cfg)
        scan_k = int(env.get("BENCH_TRAIN_SCANK",
                             "4" if batch <= 16 else "1"))
        runs.append((c, batch, f"{size}px" + ("_remat" if batch > 16
                                              else ""), scan_k))
    return {"steps": steps, "batches": batches, "size": size, "runs": runs}


def _device_batch(b: dict, dev) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in b.items()}
    out["gt_classes"] = out["gt_classes"].long()
    return out


def bench_one(cfg: ModelConfig, image_size: int, batch: int, steps: int,
              label: str, scan_k: int = 1, device="cuda",
              state: dict | None = None) -> dict:
    """``steps`` timed dispatches of ``scan_k`` SGD steps each; the
    script's JSON line (printed). ``state``: the port's train-state
    parameters (default ``init_params`` seeded 0)."""
    dev = resolve_device(device)
    params = state if state is not None else from_jax_train_params(
        init_params(cfg, torch.Generator().manual_seed(0)))
    train_state = init_train_state(params, cfg, device=dev)
    rng = np.random.default_rng(0)
    if scan_k > 1:
        step = make_train_scan_step(cfg, image_size, scan_k, device=dev)

        def make_batch():
            bs = [synth_batch(rng, batch, image_size) for _ in range(scan_k)]
            return _device_batch({k: np.stack([b[k] for b in bs])
                                  for k in bs[0]}, dev)
    else:
        step = make_train_step(cfg, image_size)

        def make_batch():
            return _device_batch(synth_batch(rng, batch, image_size), dev)

    batches = [make_batch() for _ in range(steps + 1)]
    # FLOPs: one eager step on a copy of the state, a single batch
    one = {k: v[0] for k, v in batches[0].items()} if scan_k > 1 \
        else batches[0]
    flops = flop_count(make_train_step(cfg, image_size), dict(
        _clone_state(train_state), step=0, seed=train_state["seed"]), one)

    m = step(train_state, batches[0])               # warm (and capture)
    float(m["total"])
    cuda = dev.type == "cuda"
    spans, losses = [], []
    t0 = time.perf_counter()
    for b in batches[1:]:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        m = step(train_state, b)
        if cuda:
            end.record()
            spans.append((start, end))
        losses.append(float(m["total"]))            # forces completion
    dt = time.perf_counter() - t0
    steps_per_s = steps * max(scan_k, 1) / dt
    per_step = flops
    out = {
        "metric": f"train_step_{label}",
        "batch": batch,
        "image_size": image_size,
        "scan_k": scan_k,
        "steps_per_sec": steps_per_s,
        "tiles_per_sec": steps_per_s * batch,
        "step_ms": 1000.0 / steps_per_s,
        "gflop_per_step": per_step / 1e9,
        "mfu": per_step * steps_per_s / BF16_PEAK,
        "event_step_ms": sum(s.elapsed_time(e) for s, e in spans)
        / (len(spans) * scan_k) if spans else None,
        "loss": losses[-1] if losses else float(m["total"]),
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9
        if cuda else None,
        "peak": BF16_PEAK, "peaks": PEAKS, "flops": FLOPS_COUNTED,
        "card": card(dev)}
    emit(out)
    return out


def run(env=None, device="cuda") -> list:
    """Every batch of ``BENCH_TRAIN_BATCHES``; a batch that does not fit
    on the card, or whose graph does not capture, is reported
    (``"error"``) and the next one runs."""
    s = settings(env)
    dev = resolve_device(device)
    out = []
    for cfg, batch, label, scan_k in s["runs"]:
        try:
            out.append(bench_one(cfg, s["size"], batch, s["steps"], label,
                                 scan_k=scan_k, device=dev))
        except RuntimeError as e:           # out of memory included
            if dev.type != "cuda":
                raise
            rec = {"metric": f"train_step_{label}", "batch": batch,
                   "scan_k": scan_k, "error": f"{type(e).__name__}: {e}"[
                       :400], "card": card(dev)}
            emit(rec)
            out.append(rec)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Training steps/s and MFU (knobs: BENCH_TRAIN_BATCHES, "
                    "BENCH_TRAIN_SIZE, BENCH_STEPS, BENCH_TRAIN_SCANK).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
