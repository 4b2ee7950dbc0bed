"""Seeded quality ablation: N trainings from scratch on one synthetic scene,
each checkpoint scored under every inference variant, mean ± σ of the
balanced F1 a variant.

    python -m roadsurf_tpu_torch.tools.ablate_seeded [--seeds 5]
        [--iters 600] [--batch 8] [--workdir DIR] [--out ablate_seeded.json]
        [--variants NAME,NAME] [--device cuda]

A port of the reference package's ``scripts/ablate_seeded.py``: the scene
of ``tools/quality.py`` (``write_scene``'s 16 x 16 road grid and quarry,
label preparation, tilesets from ``make_opener``'s hard tile service),
built once and reused while ``outputs/obj_detector/COCO_trn.json`` exists;
seed ``s`` trains ``quality_config(iters)`` into
``outputs/obj_detector/logs_seed{s}`` with ``training.train(...,
seed=1000 + s)`` (600 steps at B=8 on 256 px tiles); each checkpoint (the
newest, ``latest_checkpoint``) is scored under the script's 11 variants
(``VARIANTS``: the exact, dense, fast, int8 and 800 px parity profiles)
by make_detections (batch 16) and final_metrics, whose "all datasets"
``f1b`` is the run's score. Writes ``{variant: {mean, std (ddof 1),
runs}}`` with the seeds, steps and seconds to ``out`` in the workdir,
prints one JSON line a run and the summary, and returns the summary's
dict. Training and detections run on ``device``; every variant's engine
is freed before the next, and each run logs the device's peak memory.

The torch port cannot replay ``jax.random``: a seed gives other initial
weights and sampling draws than the reference's, so single runs differ and
only the seeds' spread is comparable.

``cut`` runs the whole ablation at ``tools/quality.py``'s ``CUT`` sizes
(a 4 x 4 grid, 64 px, narrow float32 heads, every proposal and detection
budget clipped to ``CUT["exact_budget"]``): what the CPU tests run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch

from ..io import read_file
from ..models.config import ModelConfig, dense_profile, fast_profile
from ..pipeline import detections, evaluate, label_prep, tilesets, training
from ..utils.config import load_config
from ..utils.device import resolve_device
from ..utils.logging import logger
from ..utils.weights import latest_checkpoint
from .quality import (CONFIG, CUT, DET_BATCH, FULL, OD, STD, global_metrics,
                      make_opener, quality_config, write_scene)


def _variants() -> dict[str, ModelConfig]:
    """The script's variants, in its order (``scripts/ablate_seeded.py``)."""
    base = replace(fast_profile(), pixel_std=STD, freeze_at=0)
    dense = replace(dense_profile(), pixel_std=STD, freeze_at=0)
    int8pyr = {"int8_scope": "full", "int8_pyramid": True}
    return {
        "exact(R1000,D100)": replace(base, fast_nms=False,
                                     rpn_pre_nms_topk_test=1000,
                                     rpn_post_nms_topk_test=1000,
                                     detections_per_image=100),
        "dense(pre1024,R256,D16)": dense,
        "fast-R64": base,
        "fast-R32": replace(base, rpn_post_nms_topk_test=32),
        "fast-R32+int8": replace(base, rpn_post_nms_topk_test=32,
                                 int8_scope="backbone"),
        "fast-R32+int8full": replace(base, rpn_post_nms_topk_test=32,
                                     int8_scope="full"),
        "fast-R32+int8pyr": replace(base, rpn_post_nms_topk_test=32,
                                    **int8pyr),
        # 16 proposals, or 4 detections: the budgets below fast-R32
        "fast-R16+int8pyr": replace(base, rpn_post_nms_topk_test=16,
                                    **int8pyr),
        "fast-R32D4+int8pyr": replace(base, rpn_post_nms_topk_test=32,
                                      detections_per_image=4, **int8pyr),
        # the parity geometry (800 px, adaptive sampling, exact NMS,
        # R1000/D100) in bf16 and on the int8 stack
        "parity800": replace(ModelConfig(), pixel_std=STD, freeze_at=0),
        "parity800+int8pyr": replace(ModelConfig(), pixel_std=STD,
                                     freeze_at=0, **int8pyr),
    }


VARIANTS = _variants()


def cut_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` at ``CUT``'s sizes: its narrow float32 heads at 64 px, and
    each budget (proposals before and after NMS, detections) clipped to
    ``CUT["exact_budget"]``."""
    pre, post, dets = CUT["exact_budget"]
    return replace(cfg, **CUT["model"],
                   rpn_pre_nms_topk_test=min(cfg.rpn_pre_nms_topk_test, pre),
                   rpn_post_nms_topk_test=min(cfg.rpn_post_nms_topk_test,
                                              post),
                   detections_per_image=min(cfg.detections_per_image, dets))


def build_scene(cfg: dict, n_grid: int = 16):
    """Labels and synthetic tilesets in the working directory, once (the
    scene is deterministic): skipped while ``COCO_trn.json`` exists."""
    if os.path.exists(f"{OD}/COCO_trn.json"):
        logger.info("scene already built, reusing")
        return
    write_scene(".", n_grid=n_grid)
    label_prep.run(cfg["prepare_data_obj_detec.py"])
    gt = read_file("outputs/json_inputs/ground_truth_labels.geojson")
    tilesets.run(cfg["generate_tilesets.py"],
                 opener=make_opener(gt.to_crs(epsg=3857)))


def _release(dev: torch.device):
    """Free what the last engine or training left on the device."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def score(cfg: dict, ckpt: str, mcfg: ModelConfig, batch: int, device,
          mask_format: str = "bits") -> dict:
    """make_detections with the checkpoint ``ckpt`` under ``mcfg``, then
    final_metrics: {"f1b", "baseline_f1", "seconds", "peak_bytes" (the
    device's peak memory over the run; None on the CPU), "files" (the
    detection files written)}. The engine is freed after."""
    det_cfg = dict(cfg["make_detections.py"])
    det_cfg["model_weights"] = {"pth_file": os.path.relpath(ckpt, OD)}
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    files = detections.run(det_cfg, model_cfg=mcfg, batch_size=batch,
                           mask_format=mask_format, device=dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    _release(dev)
    evaluate.run(cfg["final_metrics.py"])
    # the "all datasets" and baseline balanced F1, to 4 places
    gm = global_metrics()
    return {"f1b": round(gm["balanced_f1_all"], 4),
            "baseline_f1": round(gm["baseline_f1"], 4),
            "seconds": time.perf_counter() - t0, "peak_bytes": peak,
            "files": [os.path.basename(f) for f in files]}


def train_seeds(train_cfg: ModelConfig, seeds: int, iters: int, batch: int,
                image_size: int, device) -> dict:
    """Seed ``s`` trains from scratch into ``outputs/obj_detector/
    logs_seed{s}`` with the sampling seed ``1000 + s``; returns {s: its
    newest checkpoint}. Run in the scene's working directory."""
    dev = resolve_device(device)
    ckpts = {}
    for s in range(seeds):
        log_dir = f"{OD}/logs_seed{s}"
        logger.info(f"=== training seed {s} ===")
        training.train(train_cfg, f"{OD}/COCO_trn.json", f"{OD}/trn-images",
                       log_dir, max_iter=iters, batch_size=batch,
                       image_size=image_size, max_instances=16,
                       log_every=100, seed=1000 + s, device=dev)
        ckpts[s] = latest_checkpoint(log_dir)
        _release(dev)
    return ckpts


def select(variants: dict, names: str | list | None) -> dict:
    """``variants`` filtered to ``names`` (a comma-separated string or a
    list; empty or None keeps every one), in the table's order."""
    if isinstance(names, str):
        names = names.split(",") if names else None
    if not names:
        return dict(variants)
    return {k: v for k, v in variants.items() if k in names}


def summarise(rows: list[dict]) -> dict:
    """{variant: {mean, std (ddof 1), runs}} of the runs' ``f1b``, the
    variants in name order (the script's pandas group-by)."""
    out = {}
    for name in sorted({r["variant"] for r in rows}):
        runs = [r["f1b"] for r in rows if r["variant"] == name]
        std = float(np.std(runs, ddof=1)) if len(runs) > 1 else float("nan")
        out[name] = {"mean": round(float(np.mean(runs)), 4),
                     "std": round(std, 4), "runs": [float(v) for v in runs]}
    return out


def run(workdir: str, seeds: int = 5, iters: int = 600, batch: int = 8,
        variants=None, device="cuda", cut: bool = False,
        out: str = "ablate_seeded.json") -> dict:
    """The ablation in ``workdir`` (the YAML blocks' paths are relative to
    it; the working directory is restored after). Returns {"summary",
    "seeds", "iters", "elapsed_s", "rows"}, ``rows`` one {variant, seed,
    **score's dict} a run. Raises when ``device`` names CUDA and
    no CUDA device is present."""
    dev = resolve_device(device)
    tic = time.perf_counter()
    cfg = load_config(CONFIG)
    size = CUT if cut else FULL
    fit = cut_config if cut else (lambda c: c)
    train_cfg = fit(quality_config(iters))
    chosen = select(VARIANTS, variants)
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        build_scene(cfg, size["n_grid"])
        ckpts = train_seeds(train_cfg, seeds, iters, batch,
                            size["image_size"], dev)
        rows = []
        for name, mcfg in chosen.items():
            for s, ckpt in ckpts.items():
                logger.info(f"=== variant {name} seed {s} ===")
                res = score(cfg, ckpt, fit(mcfg), DET_BATCH, dev)
                rows.append({"variant": name, "seed": s, **res})
                print(json.dumps({k: v for k, v in rows[-1].items()
                                  if k != "files"}), flush=True)
        res = {"summary": summarise(rows), "seeds": seeds, "iters": iters,
               "elapsed_s": round(time.perf_counter() - tic, 1)}
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res), flush=True)
    finally:
        os.chdir(cwd)
    return {**res, "rows": rows}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Trains N seeds on one synthetic scene and scores each "
                    "under every inference variant (mean and std of the "
                    "balanced F1).")
    parser.add_argument("--seeds", type=int, default=5)
    parser.add_argument("--iters", type=int, default=600)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--workdir", default="outputs/ablate_seeded")
    parser.add_argument("--out", default="ablate_seeded.json")
    parser.add_argument("--variants", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.workdir, args.seeds, args.iters, args.batch, args.variants,
        device=args.device, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
