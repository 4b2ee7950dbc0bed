"""The whole chain with weights trained from scratch, on synthetic imagery:
label preparation -> tilesets (a synthetic tile service that draws the road
polygons) -> training -> COCO AP on the validation tileset ->
make_detections with the trained checkpoint -> final metrics, under the
fast and the exact detection profile.

    python -m roadsurf_tpu_torch.tools.quality [--iters 600] [--batch 8]
        [--workdir DIR] [--device cuda]

A port of the reference package's ``scripts/e2e_synthetic_quality.py``:
the same scene (``write_scene``: ``tests/fixtures.py``'s swissTLM3D-like
road grid at 16 x 16 roads 120 m apart, its forest and AOI, and one quarry
far from the scene), the same tile service (``make_opener``, hard mode:
road colours that cross between the classes, texture that carries the
class, grey and brown confusers, tree occluders; every tile seeded by its
(x, y) and every road by its OBJECTID), the same from-scratch training
(``quality_config``: the fast profile, std-normalised inputs, no frozen
stages, base lr 0.005, 100 warm-up steps, 128 ROIs and 64 anchors sampled
an image, 600 steps at B=8 on 256 px tiles) and the same two detection
profiles over the trained weights (the fast profile; the exact one: exact
greedy NMS, 1000 proposals, 100 detections). Beside the script's balanced
F1, precision and recall of each profile and the baseline's F1, it
records the validation tileset's COCO box and mask AP after training (the
script turns the in-loop eval off) and each stage's seconds. Host stages
run on the CPU; training, the eval and the detections on ``device``.
Prints one JSON line and returns the same dict.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import time
from dataclasses import replace

import numpy as np
import pandas as pd

from ..engine.coco_eval import evaluate_dataset
from ..geom import _native as N
from ..geom.core import LineString, Polygon
from ..geom.table import GeoDataFrame
from ..io import read_file, write_file
from ..io.xlsx import write_xlsx
from ..models.config import ModelConfig, fast_profile
from ..pipeline import detections, evaluate, label_prep, tilesets, training
from ..tiles.grid import Tile, WebMercatorQuad
from ..utils.config import load_config
from ..utils.device import resolve_device
from ..utils.logging import logger
from ..utils.weights import fold_train_params, latest_checkpoint

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "config", "config_obj_detec.yaml")
OD = "outputs/obj_detector"
DET_BATCH = 16                 # make_detections' batch, as the script's
GLOBAL_METRICS = "outputs/final/tables/global metrics.csv"
STD = (57.375, 57.12, 58.395)  # the input scaling of a start from scratch
X0, Y0 = 2600000.0, 1200000.0  # EPSG:2056, mid-Switzerland


# ---------------------------------------------------------------------------
# the scene: a copy of tests/fixtures.py's writers, and the quarry

def synthetic_roads(n_grid: int = 3, spacing: float = 300.0) -> GeoDataFrame:
    """A grid of crossing roads with mixed classes and surfaces."""
    rows = []
    oid = 1
    for i in range(n_grid):
        y = Y0 + i * spacing
        rows.append(dict(
            OBJECTID=oid, OBJEKTART=2 if i % 2 == 0 else 9,
            KUNSTBAUTE=100, BELAGSART=100 if i % 2 == 0 else 200,
            geometry=LineString([(X0, y), (X0 + n_grid * spacing, y)])))
        oid += 1
    for j in range(n_grid):
        x = X0 + j * spacing + 150
        rows.append(dict(
            OBJECTID=oid, OBJEKTART=9, KUNSTBAUTE=100,
            BELAGSART=200 if j % 2 == 0 else 100,
            geometry=LineString([(x, Y0 - 100),
                                 (x, Y0 + n_grid * spacing)])))
        oid += 1
    # one unknown-surface road off to the north (tile-exclusion path)
    rows.append(dict(
        OBJECTID=oid, OBJEKTART=9, KUNSTBAUTE=100, BELAGSART=999997,
        geometry=LineString([(X0, Y0 + 6000), (X0 + 400, Y0 + 6000)])))
    return GeoDataFrame(pd.DataFrame(rows), crs="EPSG:2056")


def synthetic_forests() -> GeoDataFrame:
    return GeoDataFrame(
        {"UUID": ["forest-1"],
         "geometry": [Polygon([(X0 + 400, Y0 + 400), (X0 + 600, Y0 + 400),
                               (X0 + 600, Y0 + 600), (X0 + 400, Y0 + 600)])]},
        crs="EPSG:2056")


def synthetic_aoi(margin: float = 800.0, span: float = 7000.0
                  ) -> GeoDataFrame:
    return GeoDataFrame(
        {"geometry": [Polygon([
            (X0 - margin, Y0 - margin), (X0 + span, Y0 - margin),
            (X0 + span, Y0 + span), (X0 - margin, Y0 + span)])]},
        crs="EPSG:2056")


def roads_parameters_df() -> pd.DataFrame:
    return pd.DataFrame({
        "GDB-Code": [2, 9, 14],
        "Type": ["Strasse", "Weg", "Faehre"],
        "to keep": ["yes", "yes", "no"],
        "Definition": ["wide road", "path", "ferry"],
        "Width": [8.0, 4.0, None],
    })


def write_scene(root: str, n_grid: int = 16, spacing: float = 120.0) -> str:
    """The reference layout's ``data/`` under ``root``: the road grid, the
    forest, the AOI (also as the restricted training AOI, so every label is
    ground truth), the road parameters, and one quarry far from the scene
    (``data/quarries/quarries.shp``). Returns the ``data/`` path."""
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "swissTLM3D"), exist_ok=True)
    os.makedirs(os.path.join(data, "AOI"), exist_ok=True)
    os.makedirs(os.path.join(data, "quarries"), exist_ok=True)
    write_file(synthetic_roads(n_grid=n_grid, spacing=spacing),
               os.path.join(data, "swissTLM3D", "roads_lines.shp"))
    write_file(synthetic_forests(),
               os.path.join(data, "swissTLM3D", "forests.shp"))
    write_file(synthetic_aoi(), os.path.join(data, "AOI", "aoi.shp"))
    write_file(synthetic_aoi(),
               os.path.join(data, "AOI", "2_tiles_AOI.shp"))
    write_xlsx(roads_parameters_df(),
               os.path.join(data, "roads_parameters.xlsx"))
    write_file(GeoDataFrame(
        {"geometry": [Polygon([(2500000, 1100000), (2500100, 1100000),
                               (2500100, 1100100), (2500000, 1100100)])]},
        crs="EPSG:2056"), os.path.join(data, "quarries", "quarries.shp"))
    return data


# ---------------------------------------------------------------------------
# the synthetic tile service

def make_opener(roads_3857, hard: bool = True):
    """A tile service drawing the road polygons (EPSG:3857, with OBJECTID
    and CATEGORY) into each requested z/x/y tile, as PNG bytes (Pillow).

    ``hard`` mode keeps the F1 off its ceiling: 40% of the roads take the
    other class's colours (texture follows the true class: smooth
    low-sigma noise for asphalt, coarse 4 px speckle for gravel, with
    overlapping sigmas), grey slabs and brown patches in the background,
    and dark green tree blobs over everything. Roads are seeded by their
    OBJECTID and tiles by (x, y), so tiles are the same from run to run.
    """
    from PIL import Image

    by_cat = {}
    for cat in ("artificial", "natural"):
        sel = roads_3857[roads_3857["CATEGORY"] == cat]
        by_cat[cat] = list(zip(sel["OBJECTID"].values,
                               sel.geometry.values))

    def road_color(cat, objectid):
        r = np.random.default_rng(int(objectid) * 2654435761 % (2 ** 31))
        if not hard:
            return (np.asarray((90, 90, 95)) if cat == "artificial"
                    else np.asarray((150, 110, 60))), 8, r
        crossed = r.random() < 0.40
        asphalt = (cat == "artificial") != crossed
        if asphalt:
            g = r.uniform(85, 130)
            base = np.asarray([g, g * r.uniform(0.96, 1.0),
                               g * r.uniform(0.92, 1.02)])
        else:
            b = r.uniform(95, 150)
            base = np.asarray([b, b * r.uniform(0.78, 0.9),
                               b * r.uniform(0.5, 0.68)])
        sigma = r.uniform(5, 20) if cat == "artificial" \
            else r.uniform(10, 26)
        return base, sigma, r

    def opener(url):
        parts = url.split("/")
        z, x, y = (int(re.match(r"\d+", p).group(0)) for p in parts[-3:])
        w, s, e, n = WebMercatorQuad.xy_bounds(Tile(x, y, z))
        sx = (e - w) / 256
        rng = np.random.default_rng((x * 73856093) ^ (y * 19349663))
        img = np.stack([rng.integers(40, 80, (256, 256)),
                        rng.integers(90, 140, (256, 256)),
                        rng.integers(40, 80, (256, 256))],
                       axis=2).astype(np.uint8)
        if hard:
            # background confusers: grey slabs and brown patches
            for _ in range(rng.integers(2, 6)):
                cx, cy = rng.integers(0, 256, 2)
                hw, hh = rng.integers(8, 40, 2)
                gray = rng.random() < 0.5
                tone = rng.uniform(90, 130)
                col = (np.asarray([tone, tone, tone * 1.02]) if gray
                       else np.asarray([tone * 1.1, tone * 0.85,
                                        tone * 0.55]))
                sl = (slice(max(cy - hh, 0), min(cy + hh, 256)),
                      slice(max(cx - hw, 0), min(cx + hw, 256)))
                img[sl] = np.clip(
                    col + rng.integers(-6, 6, (1, 1, 3)), 0,
                    255).astype(np.uint8)
        for cat, entries in by_cat.items():
            for objectid, g in entries:
                gw, gs, ge, gn = g.bounds
                if ge < w or gw > e or gn < s or gs > n:
                    continue
                mask = N.rasterize(g._flat(), w, sx, n, -sx, 256, 256)
                base, sigma, r = road_color(cat, objectid)
                if hard and cat == "natural":
                    # coarse blotchy speckle at 4 px granularity
                    coarse = r.normal(0, sigma, (64, 64, 1))
                    tex = np.repeat(np.repeat(coarse, 4, 0), 4, 1)
                    tex = tex + r.normal(0, 6, (256, 256, 1))
                else:
                    tex = r.normal(0, sigma, (256, 256, 1))
                paint = np.clip(base + tex, 0, 255).astype(np.uint8)
                img = np.where(mask[:, :, None].astype(bool), paint, img)
        if hard:
            # tree occluders over everything
            yy, xx = np.mgrid[0:256, 0:256]
            for _ in range(rng.integers(6, 14)):
                cx, cy = rng.integers(0, 256, 2)
                rad = rng.integers(4, 12)
                blob = (xx - cx) ** 2 + (yy - cy) ** 2 <= rad ** 2
                col = np.asarray([rng.integers(25, 45),
                                  rng.integers(60, 95),
                                  rng.integers(25, 45)])
                img = np.where(blob[:, :, None], col[None, None, :],
                               img).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return buf.getvalue()

    return opener


# ---------------------------------------------------------------------------
# the chain

def quality_config(iters: int) -> ModelConfig:
    """The script's from-scratch training profile (its detections use the
    same config: the fast profile)."""
    return replace(
        fast_profile(),
        pixel_std=STD,
        freeze_at=0, base_lr=0.005, warmup_iters=100,
        roi_batch_per_image=128, rpn_batch_per_image=64,
        checkpoint_period=max(iters // 2, 1), eval_period=10 ** 9)


# the exact profile's budget: proposals before and after NMS, detections
EXACT_BUDGET = (1000, 1000, 100)
# the chain's sizes: the script's, and the cut that runs on the CPU in
# seconds (a 4 x 4 road grid, 64 px training, the CPU parity tests' narrow
# float32 heads, a metrics line every step, 64 proposals and 8 detections
# in the exact profile)
FULL = {"image_size": 256, "n_grid": 16, "log_every": 50,
        "exact_budget": EXACT_BUDGET, "model": {}}
CUT = {"image_size": 64, "n_grid": 4, "log_every": 1,
       "exact_budget": (64, 64, 8),
       "model": {"fpn_channels": 32, "box_fc_dim": 64, "mask_conv_dim": 32,
                 "compute_dtype": "float32", "min_size_test": 64,
                 "max_size_test": 64}}


def exact_config(cfg: ModelConfig, budget=EXACT_BUDGET) -> ModelConfig:
    """The exact detection profile: exact greedy NMS and the reference's
    whole budget, 1000 proposals and 100 detections a tile."""
    pre, post, dets = budget
    return replace(cfg, fast_nms=False, rpn_pre_nms_topk_test=pre,
                   rpn_post_nms_topk_test=post, detections_per_image=dets)


def global_metrics(path: str = GLOBAL_METRICS) -> dict:
    """final_metrics' "all datasets" balanced F1, precision and recall, and
    the baseline's balanced F1."""
    gm = pd.read_csv(path)
    line = gm[gm["dataset"] == "all datasets"].iloc[0]
    return {"balanced_f1_all": float(line["f1b"]),
            "balanced_precision": float(line["Pb"]),
            "balanced_recall": float(line["Rb"]),
            "baseline_f1": float(
                gm[gm["dataset"] == "baseline"].iloc[0]["f1b"])}


def run(workdir: str, iters: int = 600, batch: int = 8, device="cuda",
        cut: bool = False) -> dict:
    """The chain in ``workdir`` (its YAML blocks' paths are relative to it;
    the working directory is restored after), at the script's sizes
    (``FULL``) or, with ``cut``, at ``CUT``'s. Returns {"fast":
    {balanced_f1_all, balanced_precision, balanced_recall, baseline_f1},
    "exact": {...}, "f1_delta_fast_vs_exact", "val_ap": {bbox/AP,
    segm/AP, ...}, "train_curve": metrics.jsonl's lines, "seconds": {stage:
    s}, "tiles": {dataset: count}, "elapsed_s"}. Raises when ``device``
    names CUDA and no CUDA device is present."""
    dev = resolve_device(device)
    tic = time.perf_counter()
    cfg = load_config(CONFIG)
    size = CUT if cut else FULL
    image_size = size["image_size"]
    model_cfg = replace(quality_config(iters), **size["model"])
    seconds = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        stage("scene", lambda: write_scene(".", size["n_grid"]))
        logger.info("=== 1/5 label preparation ===")
        stage("label_prep",
              lambda: label_prep.run(cfg["prepare_data_obj_detec.py"]))
        logger.info("=== 2/5 tilesets (synthetic tile service) ===")
        gt = read_file("outputs/json_inputs/ground_truth_labels.geojson")
        opener = make_opener(gt.to_crs(epsg=3857))
        stage("tilesets", lambda: tilesets.run(cfg["generate_tilesets.py"],
                                               opener=opener))
        tiles = {}
        for ds in ("trn", "val", "tst"):
            with open(f"{OD}/COCO_{ds}.json") as f:
                tiles[ds] = len(json.load(f)["images"])

        logger.info("=== 3/5 training from scratch ===")
        state = stage("train", lambda: training.train(
            model_cfg, f"{OD}/COCO_trn.json", f"{OD}/trn-images",
            f"{OD}/logs", max_iter=iters, batch_size=batch,
            image_size=image_size, max_instances=16,
            log_every=size["log_every"], device=dev))
        with open(f"{OD}/logs/metrics.jsonl") as f:
            curve = [json.loads(ln) for ln in f]
        val = training.CocoTileDataset(f"{OD}/COCO_val.json",
                                       f"{OD}/val-images", 16)
        eval_cfg = replace(model_cfg, min_size_test=image_size,
                           max_size_test=image_size)
        val_ap = stage("val_eval", lambda: evaluate_dataset(
            fold_train_params(state["params"]), eval_cfg, val, image_size,
            batch_size=batch, device=dev))
        del state

        logger.info("=== 4/5 detections with the trained weights ===")
        det_cfg = dict(cfg["make_detections.py"])
        ckpt = latest_checkpoint(f"{OD}/logs")
        det_cfg["model_weights"] = {"pth_file": os.path.relpath(ckpt, OD)}

        def profile(tag, mcfg):
            logger.info(f"=== detections and metrics [{tag}] ===")
            stage(f"detections_{tag}", lambda: detections.run(
                det_cfg, model_cfg=mcfg, batch_size=DET_BATCH, device=dev))
            stage(f"final_metrics_{tag}",
                  lambda: evaluate.run(cfg["final_metrics.py"]))
            return global_metrics()

        fast = profile("fast", model_cfg)
        exact = profile("exact", exact_config(model_cfg,
                                                 size["exact_budget"]))
    finally:
        os.chdir(cwd)
    return {"fast": fast, "exact": exact,
            "f1_delta_fast_vs_exact": round(
                fast["balanced_f1_all"] - exact["balanced_f1_all"], 4),
            "val_ap": val_ap, "train_curve": curve, "seconds": seconds,
            "tiles": tiles, "checkpoint": os.path.basename(ckpt),
            "elapsed_s": time.perf_counter() - tic}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Runs the whole chain with weights trained from "
                    "scratch on synthetic imagery and prints its quality.")
    parser.add_argument("--iters", type=int, default=600)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--workdir", default="outputs/quality")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    res = run(args.workdir, args.iters, args.batch, device=args.device)
    res.pop("train_curve")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
