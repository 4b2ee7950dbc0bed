"""Per-road surface-class aggregation from tile-level detections.

A copy of the reference package's ``pipeline/classify.py`` (the upstream
determine_class.py: the same YAML block and the same files): detections are overlaid on road polygons, each
intersection's confidence is weighted by its share of the road's area, and
per-road per-class indices Σ(weighted_score)/Σ(coverage) decide the final
cover_type ∈ {artificial, natural, undetermined, undetected} with
diff_score = |artificial − natural|.

The per-road python loop of the reference (determine_class.py:122-190) is
replaced by vectorized pandas groupbys — same math, O(P) instead of O(R·P).
Host work only (pandas and the C++ geometry core). Entry point: ``python -m
roadsurf_tpu_torch.pipeline.classify config/config_obj_detec.yaml`` (its
``determine_class.py`` block).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import pandas as pd

from ..geom.table import GeoDataFrame, overlay, sjoin
from ..io import read_excel, read_file, write_file
from ..utils.config import load_script_config
from ..utils.logging import logger
from ..utils.misc import Manifest, ensure_dir_exists, test_crs
from .tilesets import clip_labels


def get_corresponding_class(det_class: int, labels_id: pd.DataFrame) -> str:
    """Detector class id 0/1 → category name via the labels_id table
    (reference determine_class.py:19-28: det_class 0 → table id 1, 1 → 2)."""
    if det_class == 0:
        return labels_id.loc[labels_id["id"] == 1, "name"].item()
    if det_class == 1:
        return labels_id.loc[labels_id["id"] == 2, "name"].item()
    logger.error(f"Unexpected class: {det_class}")
    sys.exit(1)


def get_roads_in_quarries(quarries: GeoDataFrame, roads: GeoDataFrame):
    """Roads within 5 m-buffered quarries are split off (always natural /
    excluded from scoring; reference determine_class.py:41-60)."""
    buffered = quarries.copy()
    buffered["geometry"] = buffered.buffer(5)
    buffered = buffered.to_crs(roads.crs)
    test_crs(roads.crs, buffered.crs)

    in_quarries = sjoin(roads, buffered, predicate="within")
    ids = set(in_quarries["OBJECTID"].unique().tolist()) \
        if len(in_quarries) else set()
    not_in = roads[~roads["OBJECTID"].isin(ids)].reset_index(drop=True)
    return in_quarries, GeoDataFrame(not_in, crs=roads.crs)


def get_weighted_scores(ground_truth: GeoDataFrame,
                        predictions: GeoDataFrame,
                        min_coverage: float = 0.05) -> GeoDataFrame:
    """Overlay labels × detections; weighted_score =
    round(intersection/label_area, 2) · score; keep coverage > min_coverage
    (reference determine_class.py:97-120)."""
    gt = ground_truth.copy()
    gt["area_label"] = gt.area
    test_crs(gt.crs, predictions.crs)

    inter = overlay(gt, predictions, how="intersection",
                    keep_geom_type=True)
    if not len(inter):
        inter["area_label"] = []
        inter["joined_area"] = []
        inter["area_pred_in_label"] = []
        inter["weighted_score"] = []
        return GeoDataFrame(inter, crs=gt.crs)
    pred = inter[(~inter["BELAGSART"].isna()) &
                 (~inter["score"].isna())].copy()
    pred["joined_area"] = pred.area
    pred["area_pred_in_label"] = (pred["joined_area"]
                                  / pred["area_label"]).round(2)
    pred["weighted_score"] = pred["area_pred_in_label"] * pred["score"]
    out = pred[pred["area_pred_in_label"] > min_coverage].copy()
    return GeoDataFrame(out, crs=gt.crs)


def determine_detected_class(predictions: pd.DataFrame, roads: GeoDataFrame,
                             threshold: float = 0.0) -> GeoDataFrame:
    """Combine multiple detections per road into a final cover type.

    predictions: weighted-score rows with OBJECTID, det_class_name,
    weighted_score, area_pred_in_label, score. roads: road polygons with
    OBJECTID (+ optional CATEGORY/gt_type). Returns one row per road.
    """
    valid = predictions[predictions["score"] >= threshold]
    road_ids = pd.unique(roads["OBJECTID"])

    if len(valid):
        sums = valid.groupby(["OBJECTID", "det_class_name"])[
            ["weighted_score", "area_pred_in_label"]].sum()
        with np.errstate(invalid="ignore", divide="ignore"):
            idx = np.where(sums["weighted_score"].values == 0, 0.0,
                           sums["weighted_score"].values
                           / sums["area_pred_in_label"].values)
        sums = sums.assign(index=idx)["index"].unstack(fill_value=0.0)
    else:
        sums = pd.DataFrame()

    art = sums["artificial"] if "artificial" in sums.columns else \
        pd.Series(0.0, index=sums.index)
    nat = sums["natural"] if "natural" in sums.columns else \
        pd.Series(0.0, index=sums.index)

    # Loop-free tail (the reference's per-road loop, determine_class.py:122-190,
    # runs inside final_metrics' 20-step threshold sweeps — O(R) numpy here):
    # undetected roads get all-zero scores; detected roads argmax art/nat with
    # ties -> "undetermined" and diff_score = |art - nat| (unrounded).
    ids = pd.Index(road_ids)
    detected = ids.isin(sums.index) if len(sums) else \
        np.zeros(len(ids), bool)
    a = art.reindex(ids, fill_value=0.0).to_numpy(dtype=float)
    n = nat.reindex(ids, fill_value=0.0).to_numpy(dtype=float)
    a = np.where(detected, a, 0.0)
    n = np.where(detected, n, 0.0)
    cover = np.where(~detected, "undetected",
                     np.where(a == n, "undetermined",
                              np.where(a > n, "artificial", "natural")))
    final = pd.DataFrame({
        "road_id": road_ids,
        "cover_type": cover,
        "nat_score": np.where(detected, n.round(3), 0.0),
        "art_score": np.where(detected, a.round(3), 0.0),
        "diff_score": np.where(detected & (a != n), np.abs(a - n), 0.0),
    })
    keep = ["OBJECTID", "geometry"]
    if "gt_type" in roads.columns:
        keep.extend(["CATEGORY", "gt_type"])
    merged = final.merge(roads[keep], how="inner",
                         left_on="road_id", right_on="OBJECTID")
    return GeoDataFrame(merged, crs=roads.crs)


def weight_predictions_on_roads(roads, predictions, tiles, quarries,
                                shp_folder=None, manifest=None):
    """Shared tail of the determine_class / final_metrics runs: split off
    quarry roads (always natural; written to roads_in_quarries.shp), clip
    the remaining roads to the visible tile area, and weight the detection
    scores by intersection share in EPSG:2056.

    Returns (weighted predictions, roads without quarries)."""
    logger.info("Roads in quarries are always natural...")
    in_quarries, roads = get_roads_in_quarries(quarries, roads)
    if shp_folder:
        p = os.path.join(shp_folder, "roads_in_quarries.shp")
        write_file(in_quarries, p)
        if manifest is not None:
            manifest.add(p)

    logger.info("Limiting labels to the visible tile area...")
    visible = clip_labels(roads, tiles[["title", "id", "geometry"]].copy())

    logger.info("Weighting detection scores by intersection area...")
    visible_2056 = visible.to_crs(epsg=2056)
    predictions_2056 = predictions.to_crs(epsg=2056)
    predicted = get_weighted_scores(visible_2056, predictions_2056)
    return predicted, roads


# ---------------------------------------------------------------------------
# entry: ``determine_class.py`` YAML block

def run(cfg: dict) -> list[str]:
    initial, processed = cfg["initial_folder"], cfg["processed_folder"]
    final_folder = cfg["final_folder"]
    threshold = float(cfg.get("threshold", 0.0))
    inp = cfg["inputs"]
    out_dir = ensure_dir_exists(os.path.join(final_folder, "shp_gpkg"))
    manifest = Manifest()

    road_parameters = read_excel(os.path.join(initial, inp["road_param"]))
    roads = read_file(os.path.join(processed, inp["roads"]),
                      layer=inp.get("pred_layer"))
    labels_id = pd.read_json(
        os.path.join(processed, inp["labels_id"]), orient="index")
    logger.info("Possible classes:")
    for c in labels_id.itertuples():
        logger.info(f"- {c.id}: {c.name}, {c.supercategory}")

    predictions = read_file(os.path.join(processed, inp["detections"]))
    predictions["det_class_name"] = [
        get_corresponding_class(d, labels_id)
        for d in predictions["det_class"]]
    predictions.drop(columns=["det_class"], inplace=True)

    tiles = read_file(os.path.join(processed, inp["tiles"]))
    quarries = read_file(os.path.join(initial, inp["quarries"]))

    logger.info("Filtering the GT for the roads of interest...")
    params = road_parameters[road_parameters["to keep"] == "yes"]
    filtered = GeoDataFrame(
        roads.merge(params[["GDB-Code", "Width"]], how="inner",
                    left_on="OBJEKTART", right_on="GDB-Code"),
        crs=roads.crs)

    predicted, filtered = weight_predictions_on_roads(
        filtered, predictions, tiles, quarries, out_dir, manifest)

    final_roads = determine_detected_class(predicted, filtered, threshold)
    p = os.path.join(out_dir, "types_from_detections.shp")
    write_file(final_roads, p)
    manifest.add(p)

    manifest.log()
    return manifest.files


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="Aggregates tile-level detections into one surface "
                    "class per road.")
    parser.add_argument("config_file", type=str, nargs="?",
                        default="config/config_obj_detec.yaml")
    args = parser.parse_args(argv)
    logger.info(f"Using {args.config_file} as config file.")
    run(load_script_config(args.config_file, "determine_class.py"))
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
