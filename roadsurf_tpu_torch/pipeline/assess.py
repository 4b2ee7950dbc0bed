"""assess_detections + calculate_statistics: object-level detection QA and
tile-image band statistics.

A copy of the reference package's ``pipeline/assess.py``: native
replacements for the external object-detector stages pinned at
reference config_obj_detec.yaml:92-104 (assess_detections: per-dataset
object-level TP/FP/FN tagging of detections vs clipped labels, P-R-vs-
threshold plots — the "strongly inspired" ancestor of final_metrics.py:574)
and :58-60 (calculate_statistics: per-band mean/std over the tile images of
each dataset split, used for input normalization). Host work only.
Entry point: ``python -m roadsurf_tpu_torch.pipeline.assess
config/config_obj_detec.yaml`` (its ``assess_detections.py`` block; with
``--statistics``, its ``calculate_statistics.py`` block).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import pandas as pd

from ..geom.table import GeoDataFrame, sjoin
from ..io import read_file, write_file
from ..io.geotiff import read_geotiff
from ..utils.config import load_script_config
from ..utils.logging import logger
from ..utils.misc import Manifest, ensure_dir_exists
from ..viz import Figure
from .tilesets import clip_labels


# ---------------------------------------------------------------------------
# object-level tagging

def tag_detections(detections: GeoDataFrame, labels: GeoDataFrame,
                   iou_threshold: float = 0.25):
    """Tag each detection TP/FP and each label detected/missed.

    A detection is a TP when it overlaps a same-class label with
    IoU ≥ iou_threshold (object-level matching on the clipped labels);
    labels with no matching detection are FN.
    Returns (tagged detections, tagged labels).
    """
    dets = detections.reset_index(drop=True).copy()
    labs = labels.reset_index(drop=True).copy()
    dets["tag"] = "FP"
    labs["detected"] = False
    # best same-class TP score matched to each label: lets threshold sweeps
    # recompute which labels stay detected as low-score detections drop out
    labs["match_score"] = 0.0
    if not len(dets) or not len(labs):
        return dets, labs

    pairs = sjoin(dets, labs[["CATEGORY", "geometry"]], how="inner",
                  predicate="intersects")
    for det_idx, lab_idx in zip(pairs.index, pairs["index_right"]):
        g1 = dets.loc[det_idx, "geometry"]
        g2 = labs.loc[lab_idx, "geometry"]
        inter = g1.intersection(g2).area
        union = g1.area + g2.area - inter
        if union <= 0 or inter / union < iou_threshold:
            continue
        same = dets.loc[det_idx, "det_class_name"] == \
            labs.loc[lab_idx, "CATEGORY"]
        if same:
            dets.loc[det_idx, "tag"] = "TP"
            labs.loc[lab_idx, "detected"] = True
            labs.loc[lab_idx, "match_score"] = max(
                labs.loc[lab_idx, "match_score"],
                float(dets.loc[det_idx, "score"]))
        elif dets.loc[det_idx, "tag"] != "TP":
            dets.loc[det_idx, "tag"] = "wrong class"
    return dets, labs


def pr_sweep(dets: pd.DataFrame, labs: pd.DataFrame,
             thresholds=None) -> pd.DataFrame:
    """Precision/recall of the object-level tags vs score threshold."""
    thresholds = np.arange(0.05, 1.0, 0.05) if thresholds is None \
        else thresholds
    rows = []
    n_labels = len(labs)
    for thr in thresholds:
        keep = dets[dets["score"] >= thr]
        tp = int((keep["tag"] == "TP").sum())
        fp = int(len(keep) - tp)
        # a label stays detected while its best-matching TP survives the
        # threshold
        detected = int((labs["match_score"] >= thr).sum())
        fn = n_labels - detected
        p = tp / (tp + fp) if (tp + fp) else 0.0
        r = detected / n_labels if n_labels else 0.0
        f1 = 2 * p * r / (p + r) if (p + r) else 0.0
        rows.append({"threshold": round(float(thr), 2), "TP": tp, "FP": fp,
                     "FN": fn, "precision": p, "recall": r, "f1": f1})
    return pd.DataFrame(rows)


# ---------------------------------------------------------------------------
# entry points

def run_assessment(cfg: dict) -> list[str]:
    """``assess_detections.py`` YAML block."""
    wd = cfg["working_directory"]
    ds_cfg = cfg["datasets"]
    out_dir = ensure_dir_exists(os.path.join(wd, cfg["output_folder"]))
    manifest = Manifest()

    gt = read_file(os.path.join(wd, ds_cfg["ground_truth_labels_geojson"]))
    oth_rel = ds_cfg.get("other_labels_geojson")
    labels = gt
    if oth_rel and os.path.exists(os.path.join(wd, oth_rel)):
        oth = read_file(os.path.join(wd, oth_rel))
        labels = GeoDataFrame(pd.concat([gt, oth], ignore_index=True),
                              crs=gt.crs)
    split = read_file(os.path.join(wd, ds_cfg["split_aoi_tiles_geojson"]))

    labels_3857 = labels.to_crs(epsg=3857)
    split_3857 = split.to_crs(epsg=3857)
    clipped = clip_labels(labels_3857, split_3857[["id", "geometry"]])
    ds_of_tile = dict(zip(split["id"], split["dataset"]))
    clipped["dataset"] = [ds_of_tile.get(t) for t in clipped["tile_id"]]

    all_sweeps = []
    for ds, rel in ds_cfg["detections"].items():
        p = os.path.join(wd, rel)
        if not os.path.exists(p):
            logger.warning(f"missing detections: {p}")
            continue
        dets = read_file(p).to_crs(epsg=3857)
        if "det_class_name" not in dets.columns:
            dets["det_class_name"] = ["artificial" if c == 0 else "natural"
                                      for c in dets["det_class"]]
        labs_ds = GeoDataFrame(
            clipped[clipped["dataset"] == ds].copy(), crs=clipped.crs)
        tagged, labs_tagged = tag_detections(dets, labs_ds)
        sweep = pr_sweep(tagged, labs_tagged)
        sweep["dataset"] = ds
        all_sweeps.append(sweep)

        out = os.path.join(out_dir, f"{ds}_tagged_detections.gpkg")
        write_file(tagged, out, layer=f"{ds}_tagged")
        manifest.add(out)
        tp = int((tagged["tag"] == "TP").sum())
        logger.info(f"{ds}: {tp}/{len(tagged)} detections are TP; "
                    f"{int(labs_tagged['detected'].sum())}/{len(labs_tagged)}"
                    " labels detected")

    if all_sweeps:
        sweeps = pd.concat(all_sweeps, ignore_index=True)
        p = os.path.join(out_dir, "detection_metrics_vs_threshold.csv")
        sweeps.round(3).to_csv(p, index=False)
        manifest.add(p)

        fig = Figure()
        for ds in sweeps["dataset"].unique():
            sel = sweeps[sweeps["dataset"] == ds]
            fig.add_scatter(sel["recall"], sel["precision"], name=str(ds),
                            text=sel["threshold"])
        fig.update_layout(xaxis_title="Recall", yaxis_title="Precision",
                          xaxis={"range": [0., 1]}, yaxis={"range": [0., 1]},
                          title="Object-level precision vs recall")
        manifest.add(fig.write_html(
            os.path.join(out_dir, "precision_vs_recall.html")))

    manifest.log()
    return manifest.files


def run_statistics(cfg: dict) -> list[str]:
    """``calculate_statistics.py`` YAML block: per-band, per-dataset
    mean/std over the tile images (normalization constants)."""
    wf = cfg["working_folder"]
    tiles = read_file(os.path.join(wf, cfg["tiles"]))
    manifest = Manifest()

    stats: dict[str, dict] = {}
    for ds in sorted(tiles["dataset"].unique()):
        img_dir = os.path.join(wf, f"{ds}-images")
        if not os.path.isdir(img_dir):
            continue
        acc = None
        count = 0
        for fn in sorted(os.listdir(img_dir)):
            if not fn.endswith(".tif"):
                continue
            data = read_geotiff(os.path.join(img_dir, fn)).data
            x = data.reshape(-1, data.shape[2]).astype(np.float64)
            s = np.stack([x.sum(0), (x * x).sum(0)])
            acc = s if acc is None else acc + s
            count += x.shape[0]
        if acc is None or count == 0:
            continue
        mean = acc[0] / count
        var = acc[1] / count - mean ** 2
        stats[ds] = {"mean": [round(float(v), 3) for v in mean],
                     "std": [round(float(v), 3) for v in np.sqrt(
                         np.maximum(var, 0))],
                     "n_pixels": int(count)}
        logger.info(f"{ds}: mean={stats[ds]['mean']} std={stats[ds]['std']}")

    p = os.path.join(wf, "img_statistics.json")
    with open(p, "w") as f:
        json.dump(stats, f, indent=1)
    manifest.add(p)
    manifest.log()
    return manifest.files


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="Tags detections TP/FP vs clipped labels and writes "
                    "precision-recall sweeps; with --statistics, computes "
                    "per-band mean/std over each split's tile images.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    parser.add_argument("--statistics", action="store_true",
                        help="run the calculate_statistics.py block")
    args = parser.parse_args(argv)
    logger.info(f"Using {args.config_file} as config file.")
    if args.statistics:
        run_statistics(load_script_config(args.config_file,
                                          "calculate_statistics.py"))
    else:
        run_assessment(load_script_config(args.config_file,
                                          "assess_detections.py"))
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
