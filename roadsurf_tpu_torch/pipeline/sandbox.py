"""The sandbox tools (a copy of the reference package's
``pipeline/sandbox.py``, the upstream scripts/sandbox/): the tile-selection
limiter, the ground-truth corrector and the road-mask band. Helpers outside
the final procedure; host work (pandas, the C++ geometry core and fill).
The road network's union of ``add_tile_mask`` keeps the holes of the fields
it encloses in the port (ROADMAP Queue C, fault (a)).

Entry points, the reference's scripts: ``python -m
roadsurf_tpu_torch.pipeline.sandbox limit_used_tiles [config]`` (the
``limit_used_tiles.py`` block of config_obj_detec.yaml), ``... correct_gt
[config]`` (the ``correct_gt.py`` block of config_preprocessing.yaml) and
``... add_tile_mask [--roads ...] [--tiles ...]``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import pandas as pd

from ..geom.table import GeoDataFrame, overlay, sjoin
from ..io import read_file, write_file
from ..io.geotiff import read_geotiff, write_geotiff
from ..stats.pixels import _geometry_mask
from ..tiles.grid import parse_tile_id
from ..utils.config import load_script_config
from ..utils.logging import logger
from ..utils.misc import Manifest, ensure_dir_exists, test_crs


def limit_used_tiles(tiles: GeoDataFrame, ground_truth: GeoDataFrame,
                     other_labels: GeoDataFrame,
                     considered_datasets: str) -> GeoDataFrame:
    """The tiles that touch the considered label set and not the other
    one."""
    training_words = ["trn", "tst", "val", "gt", "ground truth"]
    has_training = any(w in considered_datasets for w in training_words)
    has_oth = "oth" in considered_datasets
    if has_training and not has_oth:
        considered, extra = ground_truth, other_labels
    elif has_oth and not has_training:
        considered, extra = other_labels, ground_truth
    else:
        raise ValueError("Unclear indications regarding the datasets to "
                         f"consider: {considered_datasets!r}")

    potential = sjoin(tiles, considered, how="left")
    potential = potential.drop_duplicates(subset=["id"])
    excluded = sjoin(tiles, extra, how="inner")
    excluded_ids = set(excluded["id"].unique()) if len(excluded) else set()
    keep = potential[~potential["id"].isin(excluded_ids)]
    out = GeoDataFrame(keep[list(tiles.columns)].reset_index(drop=True),
                       crs=tiles.crs)
    logger.info(f"{len(out)}/{len(tiles)} tiles kept.")
    return out


def correct_gt(roads: GeoDataFrame,
               corrections: GeoDataFrame) -> GeoDataFrame:
    """Field-verified ``Belag_veri`` corrections merged into BELAGSART."""
    merged = roads.merge(corrections[["OBJECTID", "Belag_veri"]],
                         on="OBJECTID", how="left")
    fixed = [int(v) if v in (100, 200, 999997, 999998) else b
             for v, b in zip(merged["Belag_veri"], merged["BELAGSART"])]
    merged["BELAGSART"] = fixed
    merged = merged.drop(columns=["Belag_veri"])
    return GeoDataFrame(merged, crs=roads.crs)


def add_tile_mask(roads: GeoDataFrame, tiles: GeoDataFrame,
                  images_root: str, mask_as_band: bool = True,
                  mask_dir: str | None = None) -> pd.DataFrame:
    """Rasterize the non-road area of each tile and append a 255-road mask
    as an extra band (or write it as a separate single-band file).

    tiles must carry ``id`` + ``dataset``; images live under
    ``{images_root}/{dataset}-images/z_x_y.tif``. Returns per-tile
    mean/std of the mask band.
    """
    union = roads.geometry.unary_union
    parts = list(getattr(union, "geoms", [union]))
    roads_union = GeoDataFrame(
        {"id_roadset": list(range(len(parts))), "geometry": parts},
        crs=roads.crs)
    test_crs(tiles.crs, roads_union.crs)
    inv = overlay(tiles, roads_union, how="difference")
    inv_3857 = inv.to_crs(epsg=3857)

    means, stds = [], []
    if mask_dir:
        ensure_dir_exists(mask_dir)
    for row in inv_3857.itertuples():
        t = parse_tile_id(row.id)
        filename = f"{t.z}_{t.x}_{t.y}.tif"
        path = os.path.join(images_root, f"{row.dataset}-images", filename)
        if not os.path.exists(path):
            continue
        r = read_geotiff(path)
        inv_mask = _geometry_mask(row.geometry, r)
        tile_mask = ((1 - inv_mask) * 255).astype(np.uint8)
        means.append(float(tile_mask.mean()))
        stds.append(float(tile_mask.std()))
        if mask_as_band:
            augmented = np.concatenate([r.data, tile_mask[:, :, None]],
                                       axis=2)
            write_geotiff(path, augmented, r.bounds, epsg=r.epsg)
        else:
            write_geotiff(os.path.join(mask_dir or images_root, filename),
                          tile_mask, r.bounds, epsg=r.epsg)
    if means:
        logger.info(f"mask means: median {np.median(means):.3f}, "
                    f"median std {np.median(stds):.3f}")
    return pd.DataFrame({"mean": means, "std": stds})


def run_limit_used_tiles(cfg: dict) -> list[str]:
    """Execute the ``limit_used_tiles.py`` YAML block
    (config_obj_detec.yaml); returns the paths written."""
    wd = cfg["working_directory"]
    manifest = Manifest()
    gt = read_file(os.path.join(wd, cfg["input_directory"],
                                cfg["ground_truth_labels"]))
    oth = read_file(os.path.join(wd, cfg["input_directory"],
                                 cfg["other_labels"]))
    tiles = read_file(os.path.join(wd, cfg["input_directory"],
                                   cfg["tiles"]))
    out = limit_used_tiles(tiles, gt, oth, cfg["considered_datasets"])
    p = os.path.join(wd, cfg["output_directory"], "tiles_aoi.geojson")
    write_file(out, p, driver="GeoJSON")
    manifest.add(p)
    manifest.log()
    return manifest.files


def run_correct_gt(cfg: dict) -> list[str]:
    """Execute the ``correct_gt.py`` YAML block (config_preprocessing.yaml):
    ``corrected_roads_inside_AOI.shp`` beside the inputs; returns the paths
    written."""
    inp = cfg["input"]
    input_dir = inp["input_folder"]
    roads = read_file(os.path.join(input_dir,
                                   inp["input_files"]["initial_roads"]))
    corrections = read_file(os.path.join(input_dir,
                                         inp["input_files"]["corrections"]))
    out = os.path.join(input_dir, "corrected_roads_inside_AOI.shp")
    write_file(correct_gt(roads, corrections), out)
    logger.info(f"Written: {out}")
    return [out]


def run_add_tile_mask(roads_path: str, tiles_path: str, images_root: str,
                      separate_files: bool = False,
                      mask_dir: str | None = None) -> pd.DataFrame:
    """The reference's add_tile_mask.py: roads and tiles read and brought
    to EPSG:3857, then ``add_tile_mask``."""
    roads = read_file(roads_path).to_crs(epsg=3857)
    tiles = read_file(tiles_path).to_crs(epsg=3857)
    stats = add_tile_mask(roads, tiles, images_root,
                          mask_as_band=not separate_files, mask_dir=mask_dir)
    logger.info(f"{len(stats)} tiles processed.")
    return stats


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="The sandbox tools: limit the tileset to the "
                    "considered labels, merge surface corrections into the "
                    "ground truth, append a road-mask band to the tiles.")
    sub = parser.add_subparsers(dest="tool", required=True)
    p = sub.add_parser("limit_used_tiles")
    p.add_argument("config_file", nargs="?",
                   default="config/config_obj_detec.yaml")
    p = sub.add_parser("correct_gt")
    p.add_argument("config_file", nargs="?",
                   default="config/config_preprocessing.yaml")
    p = sub.add_parser("add_tile_mask")
    p.add_argument("--roads",
                   default="outputs/shapefiles_gpkg/roads_for_OD.shp")
    p.add_argument("--tiles",
                   default="outputs/obj_detector/split_aoi_tiles.geojson")
    p.add_argument("--images-root", default="outputs/obj_detector")
    p.add_argument("--separate-files", action="store_true",
                   help="write masks as standalone single-band tifs "
                        "instead of appending a band")
    p.add_argument("--mask-dir", default="outputs/obj_detector/masks")
    args = parser.parse_args(argv)
    if args.tool == "add_tile_mask":
        run_add_tile_mask(args.roads, args.tiles, args.images_root,
                          args.separate_files, args.mask_dir)
    else:
        logger.info(f"Using {args.config_file} as config file.")
        block = f"{args.tool}.py"
        cfg = load_script_config(args.config_file, block)
        (run_limit_used_tiles if args.tool == "limit_used_tiles"
         else run_correct_gt)(cfg)
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
