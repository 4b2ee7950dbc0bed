"""Sub-stage profile of the RPN's proposal selection.

    python -m roadsurf_tpu_torch.tools.profile_proposals [--device cuda]

A port of the reference package's ``scripts/profile_proposals.py``:
seeded synthetic RPN outputs at the fast profile's shapes
(``fast_profile(post_nms_topk=BENCH_TOPK)``, 256 px, five levels;
``BENCH_BATCH`` 512, ``BENCH_STEPS`` 4), bf16 objectness N(0, 1) and
deltas N(0, 0.3²) from ``default_rng(0)``, ``steps + 1`` distinct sets on
the device before the clock starts, fed to cumulative pieces of
``models.rpn.select_proposals``: ``noop(dispatch floor)``, the per-level
top-k, the anchors' and deltas' gather, the decode and clip, the
per-level sweep NMS and the global top-k (the FULL row: the proposals).
The marginal column between adjacent rows is that piece's cost.

As ``select_proposals`` does, the port takes the exact top-k on every
level where the reference's TPU takes an approximate one on the large
levels (recall 0.95; exact on the CPU, where the tests compare). The
NMS rows call ``ops.nms.nms_sweep`` once a level, as the script does
(``select_proposals`` runs the levels as one padded batch).

Prints the script's table (with the event ms beside the host's) and one
JSON line a row (``bench_common``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..models.anchors import anchors_on, apply_deltas, clip_boxes
from ..models.config import ModelConfig, fast_profile
from ..ops.nms import NEG_INF, nms_sweep, top_k
from ..utils.device import resolve_device
from .bench_common import card, emit, time_steps

ROW_NAMES = ("noop(dispatch floor)", "topk", "topk+gather",
             "topk+gather+decode", "+per-level sweep NMS",
             "+global topk = FULL")


def settings(env=None) -> dict:
    """The script's knobs: {cfg, batch, steps}."""
    env = os.environ if env is None else env
    return {"cfg": fast_profile(post_nms_topk=int(env.get("BENCH_TOPK",
                                                          "32"))),
            "batch": int(env.get("BENCH_BATCH", "512")),
            "steps": int(env.get("BENCH_STEPS", "4"))}


def level_sizes(cfg: ModelConfig) -> list:
    """Anchors a level (H·W·A) at the config's test size."""
    return [a.shape[0] for a in anchors_on(
        cfg.min_size_test, cfg.fpn_strides, cfg.anchor_sizes,
        cfg.anchor_aspect_ratios, cfg.anchor_offset, torch.device("cpu"))]


def rpn_outputs(rng, batch: int, sizes: list, dev, delta_std: float = 0.3
                ) -> tuple:
    """(logits, deltas): bf16 (B, N_l) and (B, N_l, 4) a level, drawn as
    the script draws them: every level's logits, then every level's
    deltas."""
    logits = [torch.from_numpy(rng.normal(size=(batch, n)).astype(
        np.float32)).to(dev).to(torch.bfloat16) for n in sizes]
    deltas = [torch.from_numpy(rng.normal(scale=delta_std, size=(
        batch, n, 4)).astype(np.float32)).to(dev).to(torch.bfloat16)
        for n in sizes]
    return logits, deltas


def stages(cfg: ModelConfig, dev) -> list:
    """[(name, fn(logits, deltas))] of the script's rows."""
    S = cfg.min_size_test
    pre_k, post_k = cfg.rpn_pre_nms_topk_test, cfg.rpn_post_nms_topk_test
    anchors = anchors_on(S, cfg.fpn_strides, cfg.anchor_sizes,
                         cfg.anchor_aspect_ratios, cfg.anchor_offset, dev)

    def st_noop(logits, deltas):
        return [lg[:, :1] for lg in logits]

    def _topk(logits):
        return [top_k(lg.float(), min(pre_k, lg.shape[1])) for lg in logits]

    def st_topk(logits, deltas):
        return [sc for sc, _ in _topk(logits)]

    def _gathered(logits, deltas):
        out = []
        for (sc, idx), dl, an in zip(_topk(logits), deltas, anchors):
            B, k = idx.shape
            out.append((sc, an[idx], torch.gather(
                dl.float(), 1, idx[..., None].expand(B, k, 4))))
        return out

    def st_gather_only(logits, deltas):
        return [t for _, a, d in _gathered(logits, deltas) for t in (a, d)]

    def _decode(logits, deltas):
        out = []
        for sc, sel_anchors, sel_deltas in _gathered(logits, deltas):
            boxes = clip_boxes(apply_deltas(sel_deltas, sel_anchors), S, S)
            wh_ok = (boxes[..., 2] > boxes[..., 0]) \
                & (boxes[..., 3] > boxes[..., 1])
            out.append((boxes, torch.where(wh_ok, sc,
                                           torch.full_like(sc, NEG_INF))))
        return out

    def st_decode(logits, deltas):
        return [x for pair in _decode(logits, deltas) for x in pair]

    def _nms(logits, deltas):
        kept_boxes, kept_scores = [], []
        for b_l, s_l in _decode(logits, deltas):
            B, k = s_l.shape
            k_out = min(post_k, k)
            top_s, keep_i = nms_sweep(b_l, s_l, cfg.rpn_nms_thresh, k_out)
            kept_boxes.append(torch.gather(
                b_l, 1, keep_i[..., None].expand(B, k_out, 4)))
            kept_scores.append(top_s)
        return kept_boxes, kept_scores

    def st_nms(logits, deltas):
        kb, ks = _nms(logits, deltas)
        return kb + ks

    def st_full(logits, deltas):
        kb, ks = _nms(logits, deltas)
        boxes, scores = torch.cat(kb, dim=1), torch.cat(ks, dim=1)
        pscores, top_i = top_k(scores, post_k)
        B = boxes.shape[0]
        return [torch.gather(boxes, 1,
                             top_i[..., None].expand(B, post_k, 4)),
                pscores]

    return list(zip(ROW_NAMES, (st_noop, st_topk, st_gather_only,
                                st_decode, st_nms, st_full)))


def profile(fns: list, inputs: list, extra: dict) -> list:
    """Each (name, fn) timed over ``inputs`` (the first warms up); the
    rows, with their marginals."""
    rows, prev = [], 0.0
    for name, fn in fns:
        with torch.inference_mode():
            t = time_steps(fn, inputs)
        row = {"stage": name, "ms_per_batch": t["ms"],
               "event_ms_per_batch": t["event_ms"],
               "marginal_ms": t["ms"] - prev, "scalar": t["scalar"],
               **extra}
        prev = t["ms"]
        rows.append(row)
        emit(row)
    return rows


def print_table(rows: list, head: str):
    print(f"\n{head}")
    for r in rows:
        ev = r["event_ms_per_batch"]
        print(f"{r['stage']:28s} {r['ms_per_batch']:9.2f} "
              f"{r['marginal_ms']:12.2f} "
              f"{'' if ev is None else f'{ev:9.2f}'}")


def run(env=None, device="cuda", batch: int | None = None,
        steps: int | None = None) -> list:
    """The profile at the knobs of ``env`` (default: the process's);
    ``batch`` and ``steps`` override them. Returns the rows."""
    dev = resolve_device(device)
    s = settings(env)
    cfg = s["cfg"]
    batch = batch or s["batch"]
    steps = steps or s["steps"]
    sizes = level_sizes(cfg)
    print(f"batch={batch} pre_k={cfg.rpn_pre_nms_topk_test} "
          f"post_k={cfg.rpn_post_nms_topk_test} levels={sizes}",
          file=sys.stderr)
    rng = np.random.default_rng(0)
    inputs = [rpn_outputs(rng, batch, sizes, dev) for _ in range(steps + 1)]
    rows = profile(stages(cfg, dev), inputs, {
        "batch": batch, "steps": steps, "levels": sizes, "card": card(dev)})
    print_table(rows, "sub-stage                     ms/batch  marginal_ms"
                      "  event_ms")
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Per-piece cost of the RPN's proposal selection on "
                    "synthetic RPN outputs (knobs: BENCH_BATCH, "
                    "BENCH_STEPS, BENCH_TOPK).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
