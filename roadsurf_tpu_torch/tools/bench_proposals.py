"""Microbenchmark of the RPN's proposal selection, gate included.

    python -m roadsurf_tpu_torch.tools.bench_proposals [--device cuda]

A port of the reference package's ``scripts/bench_proposals.py``: seeded
synthetic RPN outputs at the fast profile's shapes (``fast_profile(
post_nms_topk=BENCH_TOPK)``, 256 px, five levels; ``BENCH_BATCH`` 512,
``BENCH_STEPS`` 4), step s's from ``default_rng(s)`` (bf16 objectness
N(0, 1) and deltas N(0, 0.2²)), all on the device before the clock
starts; the cumulative rows ``nil`` (a copy of the logits), ``gate``
(the local-max gate, ``models.rpn._local_max_gate``), ``topk`` (gated),
``decode`` and ``full`` (``select_proposals`` with the sweep NMS and the
gate, the fast profile's selection). The exact top-k stands where the
reference's TPU takes an approximate one (``tools/profile_proposals.py``).

Prints the script's lines (ms/batch, marginal) with the event ms, and one
JSON line a row (``bench_common``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.anchors import anchors_on, apply_deltas, clip_boxes
from ..models.config import ModelConfig, fast_profile
from ..models.rpn import _local_max_gate, select_proposals
from ..ops.nms import NEG_INF, top_k
from ..utils.device import resolve_device
from .bench_common import card, emit, time_steps
from .profile_proposals import rpn_outputs

ROW_NAMES = ("nil", "gate", "topk", "decode", "full")


def settings(env=None) -> dict:
    """The script's knobs: {cfg, batch, steps}."""
    env = os.environ if env is None else env
    return {"cfg": fast_profile(post_nms_topk=int(env.get("BENCH_TOPK",
                                                          "32"))),
            "batch": int(env.get("BENCH_BATCH", "512")),
            "steps": int(env.get("BENCH_STEPS", "4"))}


def level_sizes(cfg: ModelConfig) -> list:
    S = cfg.min_size_test
    return [(S // st) ** 2 * cfg.num_anchors for st in cfg.fpn_strides]


def stages(cfg: ModelConfig, dev) -> list:
    """[(name, fn(logits, deltas))] of the script's rows."""
    S = cfg.min_size_test
    pre, post = cfg.rpn_pre_nms_topk_test, cfg.rpn_post_nms_topk_test
    anchors = anchors_on(S, cfg.fpn_strides, cfg.anchor_sizes,
                         cfg.anchor_aspect_ratios, cfg.anchor_offset, dev)
    gate_geom = [(cfg.num_anchors, cfg.anchor_aspect_ratios, st, sz)
                 for st, sz in zip(cfg.fpn_strides, cfg.anchor_sizes)]

    def st_nil(logits, deltas):
        return [lg * 1.0 for lg in logits]

    def st_gate(logits, deltas):
        return [_local_max_gate(lg, *gate_geom[l], cfg.rpn_nms_thresh)
                for l, lg in enumerate(logits)]

    def st_topk(logits, deltas):
        return [top_k(lg.float(), min(pre, lg.shape[1]))
                for lg in st_gate(logits, deltas)]

    def st_decode(logits, deltas):
        out = []
        for (sc, idx), dl, an in zip(st_topk(logits, deltas), deltas,
                                     anchors):
            B, k = idx.shape
            boxes = clip_boxes(apply_deltas(torch.gather(
                dl.float(), 1, idx[..., None].expand(B, k, 4)), an[idx]),
                S, S)
            wh_ok = (boxes[..., 2] > boxes[..., 0]) \
                & (boxes[..., 3] > boxes[..., 1])
            out.append((boxes, torch.where(wh_ok, sc,
                                           torch.full_like(sc, NEG_INF))))
        return out

    def st_full(logits, deltas):
        return select_proposals(logits, deltas, anchors, S, pre, post,
                                cfg.rpn_nms_thresh, fast_nms=True,
                                local_max_gate=True, gate_geom=gate_geom)

    return list(zip(ROW_NAMES, (st_nil, st_gate, st_topk, st_decode,
                                st_full)))


def run(env=None, device="cuda", batch: int | None = None,
        steps: int | None = None) -> list:
    """The benchmark at the knobs of ``env`` (default: the process's);
    ``batch`` and ``steps`` override them. Returns the rows."""
    dev = resolve_device(device)
    s = settings(env)
    cfg = s["cfg"]
    batch = batch or s["batch"]
    steps = steps or s["steps"]
    ns = level_sizes(cfg)
    print(f"batch {batch}, levels {ns}, pre {cfg.rpn_pre_nms_topk_test}, "
          f"post {cfg.rpn_post_nms_topk_test}")
    inputs = [rpn_outputs(np.random.default_rng(seed), batch, ns, dev, 0.2)
              for seed in range(steps + 1)]
    rows, prev = [], 0.0
    for name, fn in stages(cfg, dev):
        with torch.inference_mode():
            t = time_steps(fn, inputs)
        ev = t["event_ms"]
        print(f"{name:8s} {t['ms']:8.2f} ms/batch   marginal "
              f"{t['ms'] - prev:+8.2f}"
              + ("" if ev is None else f"   event {ev:8.2f} ms"),
              flush=True)
        row = {"stage": name, "ms_per_batch": t["ms"],
               "event_ms_per_batch": ev, "marginal_ms": t["ms"] - prev,
               "scalar": t["scalar"], "batch": batch, "steps": steps,
               "card": card(dev)}
        prev = t["ms"]
        rows.append(row)
        emit(row)
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Cost of the RPN's proposal selection, gate included, "
                    "on synthetic RPN outputs (knobs: BENCH_BATCH, "
                    "BENCH_STEPS, BENCH_TOPK).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
