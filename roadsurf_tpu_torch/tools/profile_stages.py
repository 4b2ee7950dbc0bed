"""Stage-by-stage throughput profile of the inference forward.

    python -m roadsurf_tpu_torch.tools.profile_stages [--device cuda]

A port of the reference package's ``scripts/profile_stages.py``, with its
knobs: ``BENCH_PROFILE`` (``fast``: ``fast_profile(post_nms_topk=
BENCH_TOPK)`` at ``BENCH_BATCH`` 512; ``parity``: ``ModelConfig()``, the
800 px profile, at 16), ``BENCH_STEPS`` (4), ``BENCH_INT8=1`` with
``BENCH_INT8_SCOPE`` (full) and ``BENCH_INT8_PYR`` (1), and
``BENCH_STAGES`` (a comma-separated subset of the stage names). Weights
from ``init_params`` seeded 0; the int8 stack calibrated on one
``default_rng(1)`` batch of 8 tiles; ``steps + 1`` distinct batches of
random 256 px uint8 tiles from ``default_rng(0)``, on the device before
the clock starts.

Each stage is a cumulative part of the forward, from ``preprocess`` to
``+mask_head=FULL``, the whole forward with ``mask_format="logits"``
(:func:`stages`; built from the same functions as ``models.mask_rcnn.
forward_prepared``, so that the FULL row's outputs are the forward's).
The difference of consecutive rows is a stage's marginal cost. As in the
script, the int8 backbone takes the raw tiles through its uint8-direct
stem where the tiles are its size (in the ``backbone`` row, and from
``+fpn`` on with the int8 pyramid); without the pyramid, ``+fpn`` and
later rows feed it the preprocessed tiles.

Prints the script's table (ms/batch, marginal, GFLOP/tile, tiles/s) with
the event ms beside the host's, then one JSON line a row
(``bench_common`` says what the clocks and the FLOP count cover).
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import numpy as np
import torch

from ..models.config import ModelConfig, fast_profile
from ..models.mask_rcnn import _quant_tree, backbone_input, class_masks, \
    init_params, pool_levels, prepare_state, preprocess, preprocessed, \
    propose, pyramid_levels, rpn_outputs
from ..models.quant import prepare_quantized, resnet_forward_int8
from ..models.resnet import conv, max_pool, resnet_forward
from ..models.roi_heads import box_head_forward, inference_detections
from ..utils.device import compute_dtype, resolve_device
from ..utils.weights import from_jax_params
from .bench_common import FLOPS_COUNTED, card, emit, \
    flop_count, staged, time_steps

STAGE_NAMES = ("preprocess", "stem", "backbone", "+fpn", "+rpn_head",
               "+proposals(topk+nms)", "+box_head(roialign+fc)",
               "+detections(cls_nms)", "+mask_head=FULL")
TILE = 256                      # the script's tiles: 256 px, any profile
CAL_TILES = 8


def settings(env=None) -> dict:
    """The script's knobs: {cfg, batch, steps, stages}."""
    env = os.environ if env is None else env
    if env.get("BENCH_PROFILE", "fast") == "parity":
        cfg = ModelConfig()
        batch = int(env.get("BENCH_BATCH", "16"))
    else:
        cfg = fast_profile(post_nms_topk=int(env.get("BENCH_TOPK", "32")))
        batch = int(env.get("BENCH_BATCH", "512"))
    if env.get("BENCH_INT8", "0") == "1":
        cfg = replace(cfg, int8_scope=env.get("BENCH_INT8_SCOPE", "full"),
                      int8_pyramid=env.get("BENCH_INT8_PYR", "1") == "1")
    return {"cfg": cfg, "batch": batch,
            "steps": int(env.get("BENCH_STEPS", "4")),
            "stages": env.get("BENCH_STAGES", "")}


def selected(names, sel: str) -> list:
    """The stage names ``BENCH_STAGES`` keeps (all when empty)."""
    if not sel:
        return list(names)
    keep = set(sel.split(","))
    return [n for n in names if n in keep]


def stages(state: dict, cfg: ModelConfig) -> list:
    """[(name, fn)]: each ``fn(images)`` runs the forward up to its stage
    on uint8 tiles (B, H, W, 3) on the state's device and returns the
    stage's outputs; ``state`` prepared (``prepare_state``)."""
    dtype = compute_dtype(cfg)
    S = cfg.min_size_test
    q = _quant_tree(state, cfg)
    pyr = q.get("pyr") if cfg.int8_pyramid else None

    def st_preprocess(images):
        return preprocess(images, cfg, S).to(dtype)

    def st_stem(images):
        x = preprocessed(images, cfg, dtype, S)
        return max_pool(conv(x, state["backbone"]["stem"], stride=2,
                             relu=True))

    def st_backbone(images):
        if "backbone" in q:
            return resnet_forward_int8(
                q["backbone"], backbone_input(images, cfg, q, dtype, S),
                out_sas=pyr["res_sa"] if pyr is not None else None)
        return resnet_forward(state["backbone"],
                              preprocessed(images, cfg, dtype, S))

    def levels(images):
        x = backbone_input(images, cfg, q, dtype, S) if pyr is not None \
            else preprocessed(images, cfg, dtype, S)
        return pyramid_levels(state, q, x, cfg, dtype)

    def st_fpn(images):
        return levels(images)[0]

    def st_rpn_head(images):
        return rpn_outputs(state, q, levels(images)[0], cfg, dtype)

    def proposals(images):
        feats, scales = levels(images)
        logits, deltas = rpn_outputs(state, q, feats, cfg, dtype)
        props, pscores = propose(logits, deltas, cfg, S, images.device)
        return pool_levels(feats), scales, props, pscores

    def st_proposals(images):
        return proposals(images)[2:]

    def box_head(images):
        feats, scales, props, pscores = proposals(images)
        return feats, scales, props, pscores, box_head_forward(
            state["box_head"], feats, props, cfg, qp=q.get("box"),
            feat_scales=scales)

    def st_box_head(images):
        return box_head(images)[-1]

    def detections(images):
        feats, scales, props, pscores, (cl, bd) = box_head(images)
        return feats, scales, inference_detections(cl, bd, props, pscores,
                                                   cfg, S)

    def st_detections(images):
        return detections(images)[2]

    def st_full(images):
        feats, scales, dets = detections(images)
        dets["mask_logits"] = class_masks(state, q, feats, dets, cfg, scales)
        return dets

    return list(zip(STAGE_NAMES, (
        st_preprocess, st_stem, st_backbone, st_fpn, st_rpn_head,
        st_proposals, st_box_head, st_detections, st_full)))


def model_state(cfg: ModelConfig, dev: torch.device, tile: int = TILE,
                state: dict | None = None) -> dict:
    """Seed-0 weights (or ``state``'s) on ``dev``, with the int8 tree
    calibrated on the script's 8 tiles when the config asks for int8."""
    state = dict(state) if state is not None else from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(0)))
    if cfg.int8_scope:
        cal = np.random.default_rng(1).integers(
            0, 255, (CAL_TILES, tile, tile, 3), dtype=np.uint8)
        state["quant"] = prepare_quantized(state, cal, cfg, device=dev)
    return prepare_state(state, cfg, dev)


def tile_batches(batch: int, n: int, dev: torch.device,
                 tile: int = TILE) -> list:
    """``n`` batches of random uint8 tiles from ``default_rng(0)``, on
    ``dev``."""
    return staged(np.random.default_rng(0), (batch, tile, tile, 3), n, dev)


def profile(fns: list, batches: list, batch: int, extra: dict) -> list:
    """Time each (name, fn) over ``batches`` (the first warms up); ->
    the rows (their JSON lines, printed as they come)."""
    rows, prev = [], 0.0
    for name, fn in fns:
        with torch.inference_mode():
            gflop = flop_count(fn, batches[0]) / 1e9
            t = time_steps(lambda x: fn(x), [(x,) for x in batches])
        row = {"stage": name, "ms_per_batch": t["ms"],
               "event_ms_per_batch": t["event_ms"],
               "marginal_ms": t["ms"] - prev, "gflop_per_tile":
               gflop / batch, "tiles_per_sec": batch / t["ms"] * 1e3,
               "scalar": t["scalar"], "batch": batch, **extra}
        prev = t["ms"]
        rows.append(row)
        emit(row)
    return rows


def print_table(rows: list, head: str, file=None):
    print(f"\n{head}", file=file)
    for r in rows:
        ev = r.get("event_ms_per_batch")
        print(f"{r['stage']:28s} {r['ms_per_batch']:9.2f} "
              f"{r['marginal_ms']:12.2f} {r.get('gflop_per_tile', 0):11.2f} "
              f"{r.get('tiles_per_sec', 0):8.0f} "
              f"{'' if ev is None else f'{ev:9.2f}'}", file=file)


def run(env=None, device="cuda", cfg: ModelConfig | None = None,
        batch: int | None = None, steps: int | None = None,
        tile: int = TILE, state: dict | None = None) -> list:
    """The profile at the knobs of ``env`` (default: the process's);
    ``cfg``, ``batch``, ``steps``, the tiles' side and the weights
    (``state``, unprepared) override them (the tests and the card check
    run cut sizes). Returns the rows."""
    dev = resolve_device(device)
    s = settings(env)
    cfg = cfg or s["cfg"]
    batch = batch or s["batch"]
    steps = steps or s["steps"]
    names = selected(STAGE_NAMES, s["stages"])
    state = model_state(cfg, dev, tile, state)
    fns = [(n, f) for n, f in stages(state, cfg) if n in names]
    print(f"device: {card(dev)}, batch={batch}, steps={steps}",
          file=sys.stderr)
    batches = tile_batches(batch, steps + 1, dev, tile)
    rows = profile(fns, batches, batch, {
        "profile": "parity" if cfg.min_size_test == 800 else "fast",
        "int8_scope": cfg.int8_scope, "int8_pyramid": cfg.int8_pyramid,
        "steps": steps, "card": card(dev), "flops": FLOPS_COUNTED})
    print_table(rows, "stage                         ms/batch  marginal_ms"
                      "  GFLOP/tile  tiles/s  event_ms")
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Per-stage cost of the inference forward (knobs: "
                    "BENCH_PROFILE, BENCH_BATCH, BENCH_STEPS, BENCH_TOPK, "
                    "BENCH_INT8, BENCH_INT8_SCOPE, BENCH_INT8_PYR, "
                    "BENCH_STAGES).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
