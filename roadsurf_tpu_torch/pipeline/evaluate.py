"""Final metrics: threshold sweeps, balanced/weighted P-R-F1, baselines,
calibration, and HTML dashboards.

A copy of the reference package's ``pipeline/evaluate.py`` (the upstream
final_metrics.py: the same YAML block, tables and graphs): object-level TP / FP / FN with the 'wrong class' double-count rule
(final_metrics.py:22-89), a 0→0.95 step-0.05 confidence-threshold sweep on
the validation set picking the best balanced F1 (ties broken by precision,
:277-316), re-scoring of trn/tst/all/oth at the best threshold, a second
sweep on diff_score (:421-493), all-artificial / seeded-random baselines
(:498-525), CSV tables, reliability-diagram bins, and six HTML graphs.
Host work only. Entry point: ``python -m roadsurf_tpu_torch.pipeline.evaluate
config/config_obj_detec.yaml`` (its ``final_metrics.py`` block).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import pandas as pd

from ..crs import crs_equal
from ..geom.table import GeoDataFrame
from ..io import read_excel, read_file, write_file
from ..utils.config import load_script_config
from ..utils.logging import logger
from ..utils.misc import Manifest, ensure_dir_exists
from ..viz import Figure
from .classify import (determine_detected_class, get_corresponding_class,
                       weight_predictions_on_roads)
from .label_prep import determine_category


# ---------------------------------------------------------------------------
# tagging + metric math

def get_tag(cover_type: str, category: str) -> str:
    """TP / FN / 'wrong class' per road (reference final_metrics.py:91-105).
    A detected-but-misclassified road is 'wrong class' and later counts as
    both a FP for its predicted class and a FN for its true class."""
    if cover_type in ("undetermined", "undetected"):
        return "FN"
    if cover_type == category:
        return "TP"
    return "wrong class"


def tag_rows(comparison_df: pd.DataFrame) -> pd.Series:
    return pd.Series([get_tag(c, g) for c, g in
                      zip(comparison_df["cover_type"],
                          comparison_df["CATEGORY"])],
                     index=comparison_df.index)


def get_metrics(comparison_df: pd.DataFrame, classes: list[str]):
    """Per-class TP/FP/FN + Pk/Rk/F1k and global weighted + balanced
    metrics (reference final_metrics.py:22-89)."""
    rows = {"cover_class": [], "TP": [], "FP": [], "FN": [], "Pk": [],
            "Rk": [], "f1k": [], "count": []}
    tag = comparison_df["tag"]
    for cls in classes:
        is_cls_gt = comparison_df["CATEGORY"] == cls
        is_cls_pred = comparison_df["cover_type"] == cls
        tp = int(((tag == "TP") & is_cls_gt).sum())
        fp = int(((tag == "wrong class") & is_cls_pred).sum())
        fn_wrong = int(((tag == "wrong class") & is_cls_gt).sum())
        fn = int(((tag == "FN") & is_cls_gt).sum()) + fn_wrong
        pk = tp / (tp + fp) if tp else 0.0
        rk = tp / (tp + fn) if tp else 0.0
        f1k = 2 * pk * rk / (pk + rk) if tp else 0.0
        rows["cover_class"].append(cls)
        rows["TP"].append(tp)
        rows["FP"].append(fp)
        rows["FN"].append(fn)
        rows["Pk"].append(pk)
        rows["Rk"].append(rk)
        rows["f1k"].append(f1k)
        rows["count"].append(int(is_cls_gt.sum()))
    by_class = pd.DataFrame(rows)

    total = by_class["count"].sum()
    pw = (by_class["Pk"] * by_class["count"]).sum() / total if total else 0.0
    rw = (by_class["Rk"] * by_class["count"]).sum() / total if total else 0.0
    f1w = 2 * pw * rw / (pw + rw) if (pw or rw) else 0.0
    # balanced = unweighted mean over the two surface classes
    pb = by_class["Pk"].sum() / len(classes)
    rb = by_class["Rk"].sum() / len(classes)
    f1b = 2 * pb * rb / (pb + rb) if (pb or rb) else 0.0
    global_m = pd.DataFrame({"Pw": [pw], "Rw": [rw], "f1w": [f1w],
                             "Pb": [pb], "Rb": [rb], "f1b": [f1b]})
    return by_class, global_m


def show_metrics(by_class: pd.DataFrame, global_m: pd.DataFrame) -> None:
    for m in by_class.itertuples():
        logger.info(f"The {m.cover_class} roads have a precision of "
                    f"{round(m.Pk, 2)} and a recall of {round(m.Rk, 2)}.")
    logger.info(f"The final f1-score is {round(global_m.f1b[0], 2)} with a "
                f"precision of {round(global_m.Pb[0], 2)} and a recall of "
                f"{round(global_m.Rb[0], 2)}.")


def from_preds_to_metrics(predictions, ground_truth, by_class_metrics,
                          global_metrics, classes, dataset_name,
                          threshold=0.0, show=False):
    """determine class → tag → metrics, appended to the running tables
    (reference final_metrics.py:127-161)."""
    comparison = determine_detected_class(predictions, ground_truth,
                                          threshold)
    comparison["tag"] = tag_rows(comparison)
    bc, gm = get_metrics(comparison, classes)
    if show:
        show_metrics(bc, gm)
    bc = bc.assign(dataset=dataset_name, threshold=threshold)
    gm = gm.assign(dataset=dataset_name, threshold=threshold)
    return (comparison,
            pd.concat([by_class_metrics, bc], ignore_index=True),
            pd.concat([global_metrics, gm], ignore_index=True))


def sweep_score_threshold(val_predictions, val_ground_truth, classes,
                          thresholds=None):
    """Confidence-threshold sweep on the validation set; best balanced F1,
    ties broken by balanced precision (reference final_metrics.py:277-316).
    Returns (best_threshold, all_by_class, all_global, best_bc, best_gm)."""
    thresholds = np.arange(0, 1.0, 0.05) if thresholds is None else thresholds
    all_bc, all_gm = pd.DataFrame(), pd.DataFrame()
    best_thr, max_f1, max_p = 0.0, -1.0, -1.0
    best_bc = best_gm = None
    for thr in thresholds:
        comparison = determine_detected_class(val_predictions,
                                              val_ground_truth, thr)
        comparison["tag"] = tag_rows(comparison)
        bc, gm = get_metrics(comparison, classes)
        bc = bc.assign(threshold=thr)
        gm = gm.assign(threshold=thr)
        all_bc = pd.concat([all_bc, bc], ignore_index=True)
        all_gm = pd.concat([all_gm, gm], ignore_index=True)
        f1, p = float(gm.f1b[0]), float(gm.Pb[0])
        if best_bc is None or f1 > max_f1 or (f1 == max_f1 and p > max_p):
            if best_bc is not None and f1 >= max_f1:
                logger.info(f"The best threshold for the f1-score is now "
                            f"{round(thr, 2)}.")
            best_thr, max_f1, max_p = round(float(thr), 2), f1, p
            best_bc, best_gm = bc, gm
    return best_thr, all_bc, all_gm, best_bc, best_gm


def sweep_diff_threshold(best_comparison, classes, has_oth,
                         thresholds=None):
    """Sweep on diff_score: roads with |art−nat| below the threshold become
    'undetermined' (reference final_metrics.py:421-493)."""
    thresholds = np.arange(0, 1.0, 0.05) if thresholds is None else thresholds
    gt_bc_all, gt_gm_all = pd.DataFrame(), pd.DataFrame()
    oth_bc_all, oth_gm_all = pd.DataFrame(), pd.DataFrame()
    best_thr, max_f1 = 0.0, -1.0
    best_results = best_bc = best_gm = None
    for thr in thresholds:
        filtered = best_comparison.copy()
        filtered.loc[filtered["diff_score"] < thr,
                     "cover_type"] = "undetermined"
        filtered["tag"] = tag_rows(filtered)

        gt_rows = filtered[filtered["gt_type"] == "gt"]
        bc, gm = get_metrics(gt_rows, classes)
        bc = bc.assign(threshold=thr)
        gm = gm.assign(threshold=thr)
        gt_bc_all = pd.concat([gt_bc_all, bc], ignore_index=True)
        gt_gm_all = pd.concat([gt_gm_all, gm], ignore_index=True)

        if has_oth:
            oth_rows = filtered[filtered["gt_type"] == "oth"]
            obc, ogm = get_metrics(oth_rows, classes)
            oth_bc_all = pd.concat([oth_bc_all, obc.assign(threshold=thr)],
                                   ignore_index=True)
            oth_gm_all = pd.concat([oth_gm_all, ogm.assign(threshold=thr)],
                                   ignore_index=True)

        f1 = float(gm.f1b[0])
        if best_results is None or f1 > max_f1:
            best_thr, max_f1 = round(float(thr), 2), f1
            best_results, best_bc, best_gm = filtered, bc, gm
    return (best_thr, best_results, best_bc, best_gm,
            gt_bc_all, gt_gm_all, oth_bc_all, oth_gm_all)


def baseline_comparison(best_comparison, classes, baseline: str):
    """All-artificial or seeded-random baseline
    (reference final_metrics.py:498-525)."""
    comp = best_comparison.copy()
    if "artificial" in baseline:
        logger.info("Baseline: all roads classified artificial...")
        comp["cover_type"] = "artificial"
    elif baseline == "random":
        logger.info("Baseline: roads classified randomly...")
        rng = np.random.RandomState(0)
        draws = rng.randint(1, 3, size=len(comp))
        comp["cover_type"] = ["artificial" if d == 1 else "natural"
                              for d in draws]
    else:
        logger.error(f"No corresponding baseline: {baseline}")
        sys.exit(1)
    comp["tag"] = tag_rows(comp)
    return get_metrics(comp, classes)


def reliability_bins(best_comparison: pd.DataFrame):
    """Per-gt_type per-parameter bin accuracies for the reliability diagram
    (reference final_metrics.py:541-571)."""
    params = {
        "artificial": ["art_score", "artificial", "artifical score"],
        "natural": ["nat_score", "natural", "natural score"],
        "artificial_diff": ["diff_score", "artificial",
                            "score diff in artificial roads"],
        "naturall_diff": ["diff_score", "natural",
                          "score diff in natural roads"],
    }
    bins = np.arange(0, 1.05, 0.05)
    tables = []
    for gt_type in best_comparison["gt_type"].unique():
        sel = best_comparison[best_comparison["gt_type"] == gt_type]
        for key, (col, cls, label) in params.items():
            thr_vals, accs = [], []
            for thr in bins:
                rows = sel[(sel[col] > thr - 0.5) & (sel[col] <= thr)
                           & (sel["CATEGORY"] == cls)]
                if len(rows):
                    accs.append((rows["cover_type"] == cls).sum()
                                / len(rows))
                    thr_vals.append(thr)
            df = pd.DataFrame({"threshold": thr_vals, "accuracy": accs})
            df.name = f"{label} for {gt_type}"
            tables.append(df)
    return tables, bins


# ---------------------------------------------------------------------------
# plots (the reference's six HTML graphs, final_metrics.py:574-742)

def write_graphs(images_folder, classes, all_gm, all_bc, gt_filt_bc,
                 oth_filt_bc, accuracy_tables, bins, has_oth,
                 manifest: Manifest):
    fig = Figure()
    fig.add_scatter(all_gm["Rw"], all_gm["Pw"], name="weighted aggregation",
                    text=all_gm["threshold"])
    fig.add_scatter(all_gm["Rb"], all_gm["Pb"], name="balanced aggregation",
                    text=all_gm["threshold"])
    fig.update_layout(xaxis_title="Recall", yaxis_title="Precision",
                      xaxis={"range": [0., 1]}, yaxis={"range": [0., 1]})
    manifest.add(fig.write_html(os.path.join(
        images_folder, "precision_vs_recall_over_validation_set.html")))

    if len(classes) > 1:
        fig = Figure()
        for cls in classes:
            sel = all_bc[all_bc["cover_class"] == cls]
            fig.add_scatter(sel["Rk"], sel["Pk"], name=f"{cls} roads",
                            text=sel["threshold"])
        fig.update_layout(xaxis_title="Recall", yaxis_title="Precision",
                          xaxis={"range": [0., 1]}, yaxis={"range": [0., 1]})
        manifest.add(fig.write_html(os.path.join(
            images_folder,
            "precision_vs_recall_dep_on_class_over_val_set.html")))

    fig = Figure()
    for cls in classes:
        sel = all_bc[all_bc["cover_class"] == cls]
        for y in ["TP", "FN", "FP"]:
            fig.add_scatter(sel["threshold"], sel[y], name=f"{y[:2]}_{cls}")
    fig.update_layout(xaxis_title="threshold", yaxis_title="#")
    name = ("TP-FN-FP_vs_threshold_dep_on_class_over_val_set.html"
            if len(classes) > 1
            else "TP-FN-FP_vs_threshold_over_validation_set.html")
    manifest.add(fig.write_html(os.path.join(images_folder, name)))

    fig = Figure()
    for y in ["Pw", "Rw", "f1w", "Pb", "Rb", "f1b"]:
        fig.add_scatter(all_gm["threshold"], all_gm[y], name=y)
    fig.update_layout(xaxis_title="threshold")
    manifest.add(fig.write_html(os.path.join(
        images_folder, "metrics_vs_threshold_over_validation_set.html")))

    fig = Figure()
    for cls in classes:
        for y in ["Pk", "Rk"]:
            sel = gt_filt_bc[gt_filt_bc["cover_class"] == cls]
            fig.add_scatter(sel["threshold"], sel[y],
                            name=f"{y[:2]}_{cls}- gt")
            if has_oth and len(oth_filt_bc):
                osel = oth_filt_bc[oth_filt_bc["cover_class"] == cls]
                fig.add_scatter(osel["threshold"], osel[y],
                                name=f"{y[:2]}_{cls}- oth")
    fig.update_layout(xaxis_title="threshold")
    manifest.add(fig.write_html(os.path.join(
        images_folder, "metrics_vs_score_diff_threshold_dep_on_class.html")))

    fig = Figure()
    for tr in accuracy_tables:
        fig.add_scatter(tr["threshold"], tr["accuracy"], name=tr.name)
    fig.add_scatter(bins, bins, name="reference", mode="lines")
    fig.update_layout(xaxis_title="confidance threshold",
                      yaxis_title="bin accuracy",
                      title="Reliability diagram")
    manifest.add(fig.write_html(os.path.join(images_folder,
                                             "reliability_diagram.html")))


def _gt_on_tiles(gt, tiles):
    """Roads intersecting any of the given tiles, via the indexed sjoin
    (replaces a per-road python loop against one huge unary_union)."""
    from ..geom.table import sjoin
    hit = sjoin(gt, tiles[["geometry"]], how="inner")
    ids = set(hit.index)
    return GeoDataFrame(gt[gt.index.isin(ids)].copy(), crs=gt.crs)


# ---------------------------------------------------------------------------
# entry: ``final_metrics.py`` YAML block

def run(cfg: dict) -> list[str]:
    initial, processed = cfg["initial_folder"], cfg["processed_folder"]
    final_folder = cfg["final_folder"]
    baseline = cfg.get("baseline", "random")
    inp = cfg["inputs"]
    shp_folder = ensure_dir_exists(os.path.join(final_folder, "shp_gpkg"))
    manifest = Manifest()

    logger.info("Importing files...")
    road_parameters = read_excel(os.path.join(initial, inp["road_param"]))
    ground_truth = read_file(os.path.join(processed, inp["ground_truth"]))
    ground_truth["gt_type"] = "gt"
    if inp.get("other_labels") and os.path.exists(
            os.path.join(processed, inp["other_labels"])):
        oth_labels = read_file(os.path.join(processed, inp["other_labels"]))
        oth_labels["gt_type"] = "oth"
        ground_truth = GeoDataFrame(
            pd.concat([ground_truth, oth_labels], ignore_index=True),
            crs=ground_truth.crs)

    labels_id = pd.read_json(os.path.join(processed, inp["labels_id"]),
                             orient="index")
    classes = labels_id["name"].unique().tolist()

    pred_cfg = inp["to_evaluate"]
    frames = []
    for ds, rel in pred_cfg.items():
        p = os.path.join(processed, rel)
        if not os.path.exists(p):
            logger.warning(f"missing detections for {ds}: {p}")
            continue
        d = read_file(p)
        d["dataset"] = ds
        frames.append(d)
    if not frames:
        logger.error("none of the configured to_evaluate detection files "
                     "exist — run make_detections first (or fix "
                     f"processed_folder={processed!r})")
        sys.exit(1)
    # one CRS for every frame, the first file's that holds a detection (an
    # empty file carries no coordinate to read its CRS from): the frames
    # are taken in the YAML's order, which a rewrite of the file can change
    crs = next((d.crs for d in frames if len(d)), frames[0].crs)
    frames = [d if crs_equal(d.crs, crs) else
              d.to_crs(crs) if len(d) else GeoDataFrame(d, crs=crs)
              for d in frames]
    predictions = GeoDataFrame(pd.concat(frames, ignore_index=True),
                               crs=crs)
    predictions["det_class_name"] = [
        get_corresponding_class(c, labels_id)
        for c in predictions["det_class"]]
    predictions.drop(columns=["det_class"], inplace=True)

    tiles = read_file(os.path.join(processed, inp["tiles"]))
    considered_tiles = GeoDataFrame(
        tiles[tiles["dataset"].isin(pred_cfg.keys())].copy(), crs=tiles.crs)
    quarries = read_file(os.path.join(initial, inp["quarries"]))

    logger.info("Filtering the GT for the roads of interest...")
    params = road_parameters[road_parameters["to keep"] == "yes"]
    gt = GeoDataFrame(
        ground_truth.merge(params[["GDB-Code", "Width"]], how="inner",
                           left_on="OBJEKTART", right_on="GDB-Code"),
        crs=ground_truth.crs)
    gt = GeoDataFrame(gt[gt["BELAGSART"] != 999997].copy(), crs=gt.crs)
    gt["CATEGORY"] = [determine_category(b) for b in gt["BELAGSART"]]

    predicted, gt = weight_predictions_on_roads(
        gt, predictions, considered_tiles, quarries, shp_folder, manifest)
    predicted.drop(columns=["OBJEKTART", "KUNSTBAUTE", "BELAGSART",
                            "road_width", "road_len", "CATEGORY",
                            "SUPERCATEGORY", "gt_type", "GDB-Code", "Width",
                            "title", "tile_id", "area_label", "crs",
                            "joined_area"], inplace=True, errors="ignore")

    # ---- validation sweep -------------------------------------------------
    logger.info("Determining the best threshold on the validation set...")
    val_preds = predicted[predicted["dataset"] == "val"]
    val_tiles = considered_tiles[considered_tiles["dataset"] == "val"]
    val_gt = _gt_on_tiles(gt, val_tiles)

    best_thr, all_bc, all_gm, best_val_bc, best_val_gm = \
        sweep_score_threshold(val_preds, val_gt, classes)
    logger.info("Metrics for the validation dataset:")
    show_metrics(best_val_bc, best_val_gm)

    by_class = best_val_bc.assign(dataset="val")
    global_m = best_val_gm.assign(dataset="val")

    # ---- re-score at best threshold --------------------------------------
    logger.info(f"For a threshold of {best_thr}...")
    best_comparison, by_class, global_m = from_preds_to_metrics(
        predicted, gt, by_class, global_m, classes, "all datasets",
        best_thr, show=True)
    assert len(best_comparison) == len(gt), \
        "There are too many or not enough labels in the final results."

    p = os.path.join(shp_folder, "types_from_detections.shp")
    write_file(best_comparison, p)
    manifest.add(p)

    for ds in ["trn", "tst"]:
        ds_preds = predicted[predicted["dataset"] == ds]
        ds_tiles = considered_tiles[considered_tiles["dataset"] == ds]
        if not len(ds_tiles):
            continue
        ds_gt = _gt_on_tiles(gt, ds_tiles)
        _, by_class, global_m = from_preds_to_metrics(
            ds_preds, ds_gt, by_class, global_m, classes, ds, best_thr)

    trn_zone_preds = predicted[predicted["dataset"].isin(
        ["trn", "tst", "val"])]
    gt_gt = GeoDataFrame(gt[gt["gt_type"] == "gt"].copy(), crs=gt.crs)
    _, by_class, global_m = from_preds_to_metrics(
        trn_zone_preds, gt_gt, by_class, global_m, classes,
        "training zone (trn, val, tst)", best_thr, show=True)

    has_oth = "oth" in pred_cfg
    if has_oth:
        logger.info("Metrics on the inference-only (oth) zone...")
        oth_preds = predicted[predicted["dataset"] == "oth"]
        gt_oth = GeoDataFrame(gt[gt["gt_type"] == "oth"].copy(), crs=gt.crs)
        _, by_class, global_m = from_preds_to_metrics(
            oth_preds, gt_oth, by_class, global_m, classes,
            "inference-only zone", best_thr, show=True)

    if best_thr != 0:
        logger.info("Metrics keeping all predictions (threshold 0)...")
        all_preds_cmp, by_class, global_m = from_preds_to_metrics(
            predicted, gt, by_class, global_m, classes,
            "all predictions without filter", show=True)
        p = os.path.join(shp_folder, "types_from_all_detections.shp")
        write_file(all_preds_cmp, p)
        manifest.add(p)

    # ---- accuracy breakdown ----------------------------------------------
    n = len(best_comparison)
    right = (best_comparison["CATEGORY"]
             == best_comparison["cover_type"]).sum() / n * 100
    missing = (best_comparison["cover_type"] == "undetected").sum() / n * 100
    undet = (best_comparison["cover_type"] == "undetermined").sum() / n * 100
    wrong = round(100 - right - missing - undet, 2)
    logger.info(f"   {round(right, 2)}% of roads found with correct type; "
                f"{round(undet, 2)}% undetermined; "
                f"{round(missing, 2)}% undetected; {wrong}% wrong type.")

    # ---- diff_score sweep -------------------------------------------------
    logger.info("Searching the optimal threshold on the index difference...")
    (best_diff_thr, best_filtered, best_filt_bc, best_filt_gm,
     gt_filt_bc, gt_filt_gm, oth_filt_bc, oth_filt_gm) = \
        sweep_diff_threshold(best_comparison, classes, has_oth)
    if best_diff_thr > 0:
        logger.info(f"Best diff_score threshold: {best_diff_thr}")
        show_metrics(best_filt_bc, best_filt_gm)
        p = os.path.join(shp_folder, "filtered_types_from_detections.shp")
        write_file(GeoDataFrame(best_filtered, crs=gt.crs), p)
        manifest.add(p)
    else:
        logger.info("No diff_score threshold improves the results.")

    # ---- baseline ---------------------------------------------------------
    bl_bc, bl_gm = baseline_comparison(best_comparison, classes, baseline)
    show_metrics(bl_bc, bl_gm)
    by_class = pd.concat([by_class, bl_bc.assign(dataset="baseline")],
                         ignore_index=True)
    global_m = pd.concat([global_m, bl_gm.assign(dataset="baseline")],
                         ignore_index=True)

    # ---- tables -----------------------------------------------------------
    table_folder = ensure_dir_exists(os.path.join(final_folder, "tables"))
    for df, name in ((by_class, "by_class_metrics.csv"),
                     (global_m, "global metrics.csv")):
        num = df.select_dtypes(include=[np.number])
        df.loc[:, num.columns] = np.round(num, 3)
        p = os.path.join(table_folder, name)
        df.to_csv(p, index=False)
        manifest.add(p)

    # ---- calibration + graphs --------------------------------------------
    logger.info("Computing bin accuracies (calibration)...")
    accuracy_tables, bins = reliability_bins(best_comparison)
    images_folder = ensure_dir_exists(os.path.join(final_folder, "images"))
    write_graphs(images_folder, classes, all_gm, all_bc, gt_filt_bc,
                 oth_filt_bc, accuracy_tables, bins, has_oth, manifest)

    manifest.log()
    return manifest.files


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="Evaluates the per-road classification: balanced and "
                    "weighted P/R/F1, sweeps, baselines, plots.")
    parser.add_argument("config_file", type=str, nargs="?",
                        default="config/config_obj_detec.yaml")
    args = parser.parse_args(argv)
    logger.info(f"Using {args.config_file} as config file.")
    run(load_script_config(args.config_file, "final_metrics.py"))
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
