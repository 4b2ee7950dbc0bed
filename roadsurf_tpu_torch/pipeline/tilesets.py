"""Tileset generation: AOI tiles → dataset split, fetched tile imagery,
clipped labels, and COCO annotation files.

A copy of the reference package's ``pipeline/tilesets.py`` (the upstream
object detector's generate_tilesets.py stage, with the same YAML block):

* split the AOI tiles into trn/val/tst (tiles carrying ground-truth labels,
  70/15/15 deterministic shuffle) and oth (all remaining tiles)
  → ``split_aoi_tiles.geojson`` with a ``dataset`` column;
* fetch each tile's 256×256 image from the XYZ web service and write it as
  a GeoTIFF in EPSG:3857, ``z_x_y.tif``, under ``{ds}-images/`` and a
  combined ``all-images/``;
* clip labels to 0.99-scaled tiles and write a ``COCO_{ds}.json`` a
  dataset, polygon segmentations in pixel coordinates;
* write ``img_metadata.json`` (each image's georeferencing) and
  ``category_ids.json`` / ``labels_id.json`` (read back with
  ``pd.read_json(orient="index")``).

Host work only. Entry point: ``python -m
roadsurf_tpu_torch.pipeline.tilesets config/config_obj_detec.yaml`` (its
``generate_tilesets.py`` block).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import time

import numpy as np

from ..geom.affinity import scale
from ..geom.core import BaseGeometry, MultiPolygon, Polygon
from ..geom.table import GeoDataFrame, sjoin
from ..io import read_file, write_file
from ..tiles.fetch import TileFetcher
from ..tiles.grid import WebMercatorQuad, parse_tile_id
from ..utils.config import load_script_config
from ..utils.logging import logger
from ..utils.misc import Manifest, ensure_dir_exists

DATASETS = ("trn", "val", "tst", "oth")


# ---------------------------------------------------------------------------
# label clipping (shared with determine_class / final_metrics)

def clip_labels(labels_gdf: GeoDataFrame, tiles_gdf: GeoDataFrame,
                fact: float = 0.99) -> GeoDataFrame:
    """Clip labels to ``fact``-scaled tiles; the tile id lands in
    ``tile_id``. Reference: determine_class.py:62-95 (itself copied from the
    object detector's helpers)."""
    tiles = tiles_gdf.copy()
    tiles["tile_geometry"] = tiles.geometry
    assert labels_gdf.crs == tiles.crs, (labels_gdf.crs, tiles.crs)

    joined = sjoin(labels_gdf, tiles, how="inner", predicate="intersects")
    geoms = []
    for geom, tile_geom in zip(joined.geometry.values,
                               joined["tile_geometry"].values):
        shrunk = scale(tile_geom, xfact=fact, yfact=fact)
        geoms.append(geom.intersection(shrunk))
    joined["geometry"] = geoms
    joined.crs = labels_gdf.crs
    joined.drop(columns=["tile_geometry", "index_right"], inplace=True)
    joined.rename(columns={"id": "tile_id"}, inplace=True)
    return GeoDataFrame(joined, crs=labels_gdf.crs)


# ---------------------------------------------------------------------------
# dataset split

def split_tiles(tiles_gdf: GeoDataFrame, gt_labels: GeoDataFrame,
                ratios=(0.7, 0.15, 0.15), seed: int = 42) -> GeoDataFrame:
    """Assign each AOI tile a ``dataset``: tiles intersecting ground-truth
    labels are shuffled deterministically into trn/val/tst by ``ratios``;
    every other tile becomes oth."""
    assert tiles_gdf.crs == gt_labels.crs, (tiles_gdf.crs, gt_labels.crs)
    hit = sjoin(tiles_gdf[["id", "geometry"]], gt_labels[["geometry"]],
                how="inner", predicate="intersects")
    gt_tile_ids = sorted(set(hit["id"]))

    rng = random.Random(seed)
    rng.shuffle(gt_tile_ids)
    n = len(gt_tile_ids)
    n_trn = int(round(ratios[0] * n))
    n_val = int(round(ratios[1] * n))
    assign = {}
    for i, tid in enumerate(gt_tile_ids):
        if i < n_trn:
            assign[tid] = "trn"
        elif i < n_trn + n_val:
            assign[tid] = "val"
        else:
            assign[tid] = "tst"

    out = tiles_gdf.copy()
    out["dataset"] = [assign.get(t, "oth") for t in out["id"]]
    counts = out["dataset"].value_counts().to_dict()
    logger.info(f"Dataset split: {counts}")
    return out


# ---------------------------------------------------------------------------
# COCO serialization

def _poly_pixel_rings(geom: BaseGeometry, bounds, size: int):
    """Areal geometry → list of flattened [x0, y0, x1, y1, ...] pixel-space
    exterior rings (COCO polygon segmentation; holes are dropped, matching
    COCO's polygon format limits)."""
    west, south, east, north = bounds
    sx = (east - west) / size
    sy = (north - south) / size
    polys = []
    if isinstance(geom, Polygon):
        polys = [geom]
    elif isinstance(geom, MultiPolygon):
        polys = list(geom.geoms)
    else:
        for g in getattr(geom, "geoms", []):
            if isinstance(g, Polygon):
                polys.append(g)
    rings = []
    for p in polys:
        coords = p.exterior
        px = (coords[:, 0] - west) / sx
        py = (north - coords[:, 1]) / sy
        px = np.clip(px, 0, size)
        py = np.clip(py, 0, size)
        ring = np.stack([px, py], axis=1).reshape(-1)
        if len(ring) >= 6:
            rings.append([round(float(v), 2) for v in ring])
    return rings


def make_coco(tiles: GeoDataFrame, clipped_labels: GeoDataFrame,
              categories: list[dict], tile_size: int,
              metadata: dict | None = None) -> dict:
    """Build one COCO dict for the given tiles (all of one dataset) from
    clipped labels carrying CATEGORY + tile_id columns (labels in 3857)."""
    cat_id = {c["name"]: c["id"] for c in categories}
    images, annotations = [], []
    ann_id = 1
    labels_by_tile: dict[str, list] = {}
    if len(clipped_labels):
        for _, row in clipped_labels.iterrows():
            labels_by_tile.setdefault(row["tile_id"], []).append(row)

    for img_id, (_, trow) in enumerate(tiles.iterrows(), start=1):
        tile = parse_tile_id(trow["id"])
        fname = WebMercatorQuad.tile_filename(tile)
        images.append({
            "id": img_id, "file_name": fname,
            "width": tile_size, "height": tile_size,
        })
        bounds = WebMercatorQuad.xy_bounds(tile)
        for lrow in labels_by_tile.get(trow["id"], []):
            geom = lrow["geometry"]
            if geom is None or geom.is_empty:
                continue
            rings = _poly_pixel_rings(geom, bounds, tile_size)
            if not rings:
                continue
            xs = [v for ring in rings for v in ring[0::2]]
            ys = [v for ring in rings for v in ring[1::2]]
            x0, y0 = min(xs), min(ys)
            bbox = [x0, y0, max(xs) - x0, max(ys) - y0]
            sx = (bounds[2] - bounds[0]) / tile_size
            annotations.append({
                "id": ann_id, "image_id": img_id,
                "category_id": cat_id[lrow["CATEGORY"]],
                "segmentation": rings,
                "bbox": [round(v, 2) for v in bbox],
                "area": round(geom.area / (sx * sx), 2),
                "iscrowd": 0,
            })
            ann_id += 1

    coco = {
        "info": metadata or {},
        "licenses": [dict(metadata.get("license", {}), id=1)
                     ] if metadata and "license" in metadata else [],
        "images": images,
        "annotations": annotations,
        "categories": categories,
    }
    return coco


# ---------------------------------------------------------------------------
# driver

def run(cfg: dict, opener=None, timings: dict | None = None) -> list[str]:
    """Execute tileset generation from the ``generate_tilesets.py`` YAML
    block; returns the paths written. ``opener`` (``bytes = opener(url)``)
    replaces the HTTP opener. A ``timings`` dict receives each stage's
    seconds ("split", "clip", "fetch", "coco")."""
    timings = {} if timings is None else timings
    wd = cfg["working_directory"]
    out_dir = ensure_dir_exists(os.path.join(wd, cfg["output_folder"]))
    tile_size = int(cfg.get("tile_size", 256))
    overwrite = bool(cfg.get("overwrite", False))
    n_jobs = int(cfg.get("n_jobs", 10))
    # the reference uses both spellings: a dict (config_obj_detec.yaml:33-35)
    # and a bare scalar (config_stats.yaml:34 "debug_mode: true")
    debug = cfg.get("debug_mode", {}) or {}
    if not isinstance(debug, dict):
        debug = {"enable": bool(debug)}
    ds_cfg = cfg["datasets"]
    manifest = Manifest()

    tiles = read_file(os.path.join(wd, ds_cfg["aoi_tiles_geojson"]))
    # GT labels are OPTIONAL: the statistical branch's tileset pass
    # (reference config_stats.yaml:32-44) supplies only aoi_tiles + the
    # web service — inference-only mode, every tile lands in 'oth' and
    # the COCO files carry zero annotations
    gt_path = ds_cfg.get("ground_truth_labels_geojson")
    gt = read_file(os.path.join(wd, gt_path)) if gt_path else None
    oth_path = ds_cfg.get("other_labels_geojson")
    oth = (read_file(os.path.join(wd, oth_path))
           if oth_path and os.path.exists(os.path.join(wd, oth_path))
           else None)

    if debug.get("enable"):
        cap = int(debug.get("nb_tiles_max", 100))
        logger.warning(f"Debug mode: only {cap} tiles considered.")
        tiles = GeoDataFrame(tiles.iloc[:cap].copy(), crs=tiles.crs)

    # --- split ------------------------------------------------------------
    t0 = time.perf_counter()
    if gt is not None:
        split = split_tiles(tiles, gt)
    else:
        split = GeoDataFrame(tiles[["id", "geometry"]].copy(),
                             crs=tiles.crs)
        split["dataset"] = "oth"
    p = os.path.join(out_dir, "split_aoi_tiles.geojson")
    write_file(split, p, driver="GeoJSON")
    manifest.add(p)

    # --- categories -------------------------------------------------------
    names = sorted(set(gt["CATEGORY"])) if gt is not None else []
    categories = [{"id": i + 1, "name": n,
                   "supercategory": gt["SUPERCATEGORY"].iloc[0]
                   if "SUPERCATEGORY" in gt.columns else "road"}
                  for i, n in enumerate(names)]
    cat_table = {str(i): {"id": c["id"], "name": c["name"],
                          "supercategory": c["supercategory"]}
                 for i, c in enumerate(categories)}
    for fname in ("category_ids.json", "labels_id.json"):
        p = os.path.join(out_dir, fname)
        with open(p, "w") as f:
            json.dump(cat_table, f, indent=1)
        manifest.add(p)

    timings["split"] = time.perf_counter() - t0

    # --- clip labels to tiles (3857) --------------------------------------
    t0 = time.perf_counter()
    split_3857 = split.to_crs(epsg=3857)
    if gt is not None:
        gt_3857 = gt.to_crs(epsg=3857)
        clipped = clip_labels(gt_3857, split_3857[["id", "geometry"]])
    else:
        clipped = GeoDataFrame(
            {"CATEGORY": [], "tile_id": [], "geometry": []},
            crs="EPSG:3857")
    if oth is not None and len(oth):
        oth_3857 = oth.to_crs(epsg=3857)
        clipped_oth = clip_labels(oth_3857, split_3857[["id", "geometry"]])
    else:
        clipped_oth = None

    timings["clip"] = time.perf_counter() - t0

    # --- fetch imagery ----------------------------------------------------
    t0 = time.perf_counter()
    svc = ds_cfg.get("orthophotos_web_service", {})
    url = svc.get("url")
    fetcher = TileFetcher(url, opener=opener, n_jobs=n_jobs) if url else None

    all_dir = ensure_dir_exists(os.path.join(out_dir, "all-images"))
    img_meta: dict[str, dict] = {}
    for ds in DATASETS:
        sel = split[split["dataset"] == ds]
        ds_dir = ensure_dir_exists(os.path.join(out_dir, f"{ds}-images"))
        ts = [parse_tile_id(t) for t in sel["id"]]
        if fetcher is not None and ts:
            fetcher.fetch_many(ts, ds_dir, overwrite=overwrite)
            # hard-link into all-images (one download, two views)
            for t in ts:
                fn = WebMercatorQuad.tile_filename(t)
                src = os.path.join(ds_dir, fn)
                dst = os.path.join(all_dir, fn)
                if not os.path.exists(dst):
                    try:
                        os.link(src, dst)
                    except OSError:
                        shutil.copy2(src, dst)
        for t, tid in zip(ts, sel["id"]):
            w, s, e, n = WebMercatorQuad.xy_bounds(t)
            img_meta[WebMercatorQuad.tile_filename(t)] = {
                "id": tid, "x": t.x, "y": t.y, "z": t.z,
                "dataset": ds, "width": tile_size, "height": tile_size,
                "bounds_3857": [w, s, e, n], "crs": "EPSG:3857",
            }

    p = os.path.join(out_dir, "img_metadata.json")
    with open(p, "w") as f:
        json.dump(img_meta, f, indent=1)
    manifest.add(p)

    timings["fetch"] = time.perf_counter() - t0

    # --- COCO files -------------------------------------------------------
    t0 = time.perf_counter()
    meta = cfg.get("COCO_metadata", {})
    for ds in DATASETS:
        sel = split[split["dataset"] == ds]
        if ds == "oth":
            lab = clipped_oth if clipped_oth is not None else \
                clipped.iloc[0:0]
        else:
            lab = clipped
        sel_ids = set(sel["id"])
        lab_ds = lab[lab["tile_id"].isin(sel_ids)] if len(lab) else lab
        coco = make_coco(sel, lab_ds, categories, tile_size, meta)
        p = os.path.join(out_dir, f"COCO_{ds}.json")
        with open(p, "w") as f:
            json.dump(coco, f)
        manifest.add(p)
        logger.info(f"COCO_{ds}.json: {len(coco['images'])} images, "
                    f"{len(coco['annotations'])} annotations")
    timings["coco"] = time.perf_counter() - t0

    manifest.log()
    return manifest.files


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="Generates the tilesets (images + COCO annotations) "
                    "for the road-surface detector.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    args = parser.parse_args(argv)
    logger.info(f"Using {args.config_file} as config file.")
    run(load_script_config(args.config_file, "generate_tilesets.py"))
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
