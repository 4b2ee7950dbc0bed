"""Sub-stage costs of the box and mask heads (pooler against FCs or convs)
and of the int8 backbone and FPN, at the deployment config.

    python -m roadsurf_tpu_torch.tools.profile_heads [--device cuda]

A port of the reference package's ``scripts/profile_heads.py``: the fast
profile (``post_nms_topk=BENCH_TOPK``) on the int8 stack (full scope,
int8 pyramid) at ``BENCH_BATCH`` 512, ``BENCH_STEPS`` 4; weights from
``init_params`` seeded 0, calibrated on one ``default_rng(1)`` batch of 8
tiles; ``steps + 1`` distinct input sets from ``default_rng(0)`` (int8
P2..P5 levels, R proposals a tile, uint8 tiles), drawn as the script
draws them and put on the device before the clock starts. Each row is a
call of its own: the ``noop(dispatch floor)``, the box pooler (K1 on the
card), the box head, the mask pooler on the first D boxes, the mask
head, the int8 backbone from raw tiles through its uint8-direct stem,
and the backbone with the int8-pyramid FPN. Subtract the noop row from
the others.

Prints the script's table (with the event ms) and one JSON line a row
(``bench_common``).
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import numpy as np
import torch

from ..models.config import ModelConfig, fast_profile
from ..models.quant import fpn_forward_int8_pyr, resnet_forward_int8
from ..models.roi_heads import box_head_forward, mask_head_forward
from ..ops.roi_align import roi_align_multilevel
from ..utils.device import compute_dtype, resolve_device
from .bench_common import card, emit, time_steps
from .profile_stages import model_state


def settings(env=None) -> dict:
    """The script's knobs: {cfg, batch, steps}."""
    env = os.environ if env is None else env
    cfg = fast_profile(post_nms_topk=int(env.get("BENCH_TOPK", "32")))
    return {"cfg": replace(cfg, int8_scope="full", int8_pyramid=True),
            "batch": int(env.get("BENCH_BATCH", "512")),
            "steps": int(env.get("BENCH_STEPS", "4"))}


def row_names(cfg: ModelConfig) -> list:
    R, D = cfg.rpn_post_nms_topk_test, cfg.detections_per_image
    return ["noop(dispatch floor)", "box pooler (R=%d)" % R,
            "box pooler+FCs", "mask pooler (D=%d)" % D, "mask pooler+convs",
            "backbone int8 (u8 stem)", "backbone+fpn int8 pyr"]


def inputs(rng, cfg: ModelConfig, batch: int, dev, tile: int = 256
           ) -> tuple:
    """(int8 P2..P5 levels NHWC, proposals (B, R, 4), uint8 tiles): the
    script's draws, in its order."""
    S, R = cfg.min_size_test, cfg.rpn_post_nms_topk_test
    sizes = [(S + s - 1) // s for s in cfg.fpn_strides[:4]]
    C = cfg.fpn_channels                # 256, as the script has it
    feats = [torch.from_numpy(rng.integers(-127, 127, (batch, h, h, C),
                                           dtype=np.int8)).to(dev)
             for h in sizes]
    b = rng.uniform(8, 200, (batch, R, 4)).astype(np.float32)
    b = np.stack([np.minimum(b[..., 0], b[..., 2]),
                  np.minimum(b[..., 1], b[..., 3]),
                  np.maximum(b[..., 0], b[..., 2]) + 8,
                  np.maximum(b[..., 1], b[..., 3]) + 8], -1)
    imgs = rng.integers(0, 255, (batch, tile, tile, 3), dtype=np.uint8)
    return feats, torch.from_numpy(b).to(dev), torch.from_numpy(imgs).to(dev)


def stages(state: dict, cfg: ModelConfig) -> list:
    """[(name, fn(feats, props, imgs))] of the script's rows; ``state``
    prepared, with its calibrated ``quant``."""
    q = state["quant"]
    scales = q["pyr"]["out_sa"]
    D = cfg.detections_per_image
    dtype = compute_dtype(cfg)

    def pool(feats, boxes, P):
        return roi_align_multilevel(
            feats, boxes, P, sampling=cfg.pooler_sampling_ratio,
            canonical_size=cfg.canonical_box_size,
            canonical_level=cfg.canonical_level, feat_scales=scales)

    def st_noop(feats, props, imgs):
        return props[:, :1, :1]

    def st_box_pool(feats, props, imgs):
        return pool(feats, props, cfg.box_pooler_resolution)

    def st_box_full(feats, props, imgs):
        return box_head_forward(state["box_head"], feats, props, cfg,
                                qp=q.get("box"), feat_scales=scales)

    def st_mask_pool(feats, props, imgs):
        return pool(feats, props[:, :D], cfg.mask_pooler_resolution)

    def st_mask_full(feats, props, imgs):
        return mask_head_forward(state["mask_head"], feats, props[:, :D],
                                 cfg, qp=q.get("mask"), feat_scales=scales)

    def st_backbone(feats, props, imgs):
        return resnet_forward_int8(q["backbone"], imgs.permute(0, 3, 1, 2),
                                   out_sas=q["pyr"]["res_sa"])

    def st_bb_fpn(feats, props, imgs):
        return fpn_forward_int8_pyr(q["fpn"], q["pyr"], st_backbone(
            feats, props, imgs), dtype)

    return list(zip(row_names(cfg), (
        st_noop, st_box_pool, st_box_full, st_mask_pool, st_mask_full,
        st_backbone, st_bb_fpn)))


def run(env=None, device="cuda", cfg: ModelConfig | None = None,
        batch: int | None = None, steps: int | None = None,
        tile: int = 256, state: dict | None = None) -> list:
    """The profile at the knobs of ``env`` (default: the process's);
    ``cfg``, ``batch``, ``steps``, the tiles' side and the weights
    override them. Returns the rows."""
    dev = resolve_device(device)
    s = settings(env)
    cfg = cfg or s["cfg"]
    batch = batch or s["batch"]
    steps = steps or s["steps"]
    prepared = model_state(cfg, dev, tile, state)
    rng = np.random.default_rng(0)
    sets = [inputs(rng, cfg, batch, dev, tile) for _ in range(steps + 1)]
    print(f"batch={batch} R={cfg.rpn_post_nms_topk_test} "
          f"D={cfg.detections_per_image}", file=sys.stderr)
    rows = []
    for name, fn in stages(prepared, cfg):
        with torch.inference_mode():
            t = time_steps(fn, sets)
        row = {"stage": name, "ms_per_batch": t["ms"],
               "event_ms_per_batch": t["event_ms"], "scalar": t["scalar"],
               "batch": batch, "steps": steps, "card": card(dev)}
        rows.append(row)
        emit(row)
    print("\nsub-stage                     ms/batch  event_ms")
    for r in rows:
        ev = r["event_ms_per_batch"]
        print(f"{r['stage']:28s} {r['ms_per_batch']:9.2f} "
              f"{'' if ev is None else f'{ev:9.2f}'}")
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Costs of the heads' poolers, FCs and convs and of the "
                    "int8 backbone and FPN (knobs: BENCH_BATCH, "
                    "BENCH_STEPS, BENCH_TOPK).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
