"""Label preparation: swissTLM3D road *lines* → road *polygon*
instance-segmentation labels, the z18 tile grid over them, and the GT/OTH
label split.

A copy of the reference package's ``pipeline/label_prep.py`` (the upstream
prepare_data_obj_detec.py: the same YAML block and the same files,
``roads_for_OD.shp``, ``tiles_aoi.geojson`` and
``{ground_truth,other}_labels.geojson``): three stage functions and a
``run`` driver, host work only (numpy, pandas and the C++ geometry core).
Entry point: ``python -m roadsurf_tpu_torch.pipeline.label_prep
config/config_obj_detec.yaml`` (its ``prepare_data_obj_detec.py`` block).
"""

from __future__ import annotations

import argparse
import os
import re
import time

import pandas as pd

from ..geom.cleanup import (intersecting_pairs, keep_largest_part,
                            polygons_diff_without_artifacts, test_valid_geom)
from ..geom.table import GeoDataFrame, sjoin, overlay
from ..io import read_excel, read_file, write_file
from ..tiles.grid import WebMercatorQuad
from ..utils.config import load_script_config
from ..utils.logging import logger
from ..utils.misc import Manifest, ensure_dir_exists, test_crs

# swissTLM3D semantics (reference prepare_data_obj_detec.py:57-62):
# OBJEKTART codes that are not actual roads (places, motorail, ferry, marked
# trace, climbing path, provisional soft-mobility paths).
NOT_ROAD = [12, 13, 14, 19, 22, 23]
# KUNSTBAUTE: keep plain roads (100) and uncovered bridges (200).
KUNSTBAUTE_TO_KEEP = [100, 200]
# BELAGSART: artificial (100) or natural (200) surfaces.
BELAGSART_TO_KEEP = [100, 200]

# swissTLM3D metadata columns irrelevant downstream.
_DROP_COLS = [
    "DATUM_AEND", "DATUM_ERST", "ERSTELLUNG", "ERSTELLU_1", "UUID",
    "REVISION_J", "REVISION_M", "GRUND_AEND", "HERKUNFT", "HERKUNFT_J",
    "HERKUNFT_M", "REVISION_Q", "WANDERWEGE", "VERKEHRSBE",
    "BEFAHRBARK", "EROEFFNUNG", "STUFE", "RICHTUNGSG",
    "KREISEL", "EIGENTUEME", "VERKEHRS_1", "NAME",
    "TLM_STRASS", "STRASSENNA", "SHAPE_Leng",
]


def determine_category(belagsart) -> str:
    """BELAGSART 100 → artificial, 200 → natural, else 'else'
    (reference prepare_data_obj_detec.py:82-88)."""
    if belagsart == 100:
        return "artificial"
    if belagsart == 200:
        return "natural"
    return "else"


def _width_rank(objektart: pd.Series) -> pd.Series:
    """Road-class ordering used to decide who cuts whom in the de-overlap:
    lower OBJEKTART code ≈ wider class, with codes 20 and 21 re-ranked to
    8.5 and 2.5 (reference prepare_data_obj_detec.py:153-163)."""
    rank = objektart.astype(float).copy()
    rank[objektart == 20] = 8.5
    rank[objektart == 21] = 2.5
    return rank


def determine_road_surfaces(roads: GeoDataFrame, forests: GeoDataFrame,
                            roads_parameters: pd.DataFrame) -> GeoDataFrame:
    """Stage 1: filter TLM road lines, buffer them to polygons by per-class
    width, remove overlaps wider-over-narrower, subtract forest canopy.

    Reference behavior: prepare_data_obj_detec.py:92-196.
    """
    logger.info("Filtering the considered roads...")
    roi = roads[~roads["OBJEKTART"].isin(NOT_ROAD)]
    uncovered = roi[roi["KUNSTBAUTE"].isin(KUNSTBAUTE_TO_KEEP)].copy()

    params = roads_parameters[~roads_parameters["Width"].isna()].copy()
    params.drop_duplicates(subset="GDB-Code", inplace=True)
    uncovered = uncovered.merge(params[["GDB-Code", "Width"]], how="inner",
                                left_on="OBJEKTART", right_on="GDB-Code")
    uncovered = GeoDataFrame(uncovered, crs=roads.crs)
    uncovered.drop(columns=_DROP_COLS, inplace=True, errors="ignore")

    logger.info("Transforming the roads from lines to polygons...")
    uncovered["road_len"] = uncovered.length.round(3)

    buffered = uncovered.copy()
    # flat caps (cap_style=2) so segment ends don't disc out past junctions
    polys = buffered.buffer(buffered["Width"] / 2, cap_style=2)
    # roundabout buffers can self-intersect into MultiPolygons; keep the body
    buffered["geometry"] = [keep_largest_part(g) for g in polys.values]

    logger.info("Removing overlap between roads of different classes...")
    pairs = intersecting_pairs(buffered, ["OBJECTID", "OBJEKTART"])

    pairs = pairs.assign(_rank1=_width_rank(pairs["OBJEKTART_1"]),
                         _rank2=_width_rank(pairs["OBJEKTART_2"]))
    # keep directed pairs where road 1 is the wider (lower-ranked) class:
    # the narrower road 2 yields its overlap to road 1
    cuts = pairs[pairs["_rank1"] < pairs["_rank2"]].copy()
    cuts.sort_values(by=["_rank1"], inplace=True, kind="stable")
    cuts.sort_values(by=["KUNSTBAUTE"], ascending=False, inplace=True,
                     ignore_index=True, kind="stable")

    corr = buffered.copy()
    for row in cuts.itertuples():
        p1 = corr.index[corr["OBJECTID"] == row.OBJECTID_1].values
        p2 = corr.index[corr["OBJECTID"] == row.OBJECTID_2].values
        if not len(p1) or not len(p2):
            continue
        corr = polygons_diff_without_artifacts(corr, int(p1[0]), int(p2[0]),
                                               keep_everything=True)
    corr = GeoDataFrame(corr)
    corr.drop(columns=["saved_geom"], inplace=True, errors="ignore")
    corr.set_crs(epsg=2056, inplace=True)

    logger.info("Excluding roads under forest canopy...")
    test_crs(corr.crs, forests.crs)
    forests = forests.copy()
    forests["geometry"] = forests.buffer(3)
    cols = [c for c in ("UUID", "geometry") if c in forests.columns]
    non_forest = overlay(corr, forests[cols], how="difference")

    non_forest.drop(columns=["GDB-Code"], inplace=True, errors="ignore")
    non_forest.rename(columns={"Width": "road_width"}, inplace=True)
    logger.success("Done determining the surface of the roads from lines!")
    return non_forest


def generate_tiles_info(non_forest_roads: GeoDataFrame, aoi: GeoDataFrame,
                        roads_parameters: pd.DataFrame,
                        zoom_level: int = 18) -> GeoDataFrame:
    """Stage 2: z-`zoom_level` WebMercator tile grid over the in-AOI roads,
    excluding tiles that touch any road of unknown surface type.

    Reference behavior: prepare_data_obj_detec.py:211-286. Returns the tile
    GeoDataFrame in EPSG:3857 with ``title`` and formatted ``id`` columns.
    """
    params = roads_parameters[roads_parameters["to keep"] == "yes"].copy()
    params.drop_duplicates(subset="GDB-Code", inplace=True)

    roi = non_forest_roads.merge(params[["GDB-Code"]], how="right",
                                 left_on="OBJEKTART", right_on="GDB-Code")
    roi = GeoDataFrame(roi, crs=non_forest_roads.crs)
    roi = roi[roi["geometry"].notna()]
    excluded_ids = roi[~roi["BELAGSART"].isin(BELAGSART_TO_KEEP)][
        "OBJECTID"].unique().tolist()

    aoi_geom = GeoDataFrame({"id": [0],
                             "geometry": [aoi.geometry.unary_union]},
                            crs=aoi.crs)
    if aoi_geom.crs != roi.crs:
        aoi_geom = aoi_geom.to_crs(roi.crs)
    roi_in_aoi = overlay(roi, aoi_geom, how="intersection")
    roi_in_aoi = test_valid_geom(roi_in_aoi, gdf_obj_name="roads")
    roi_in_aoi.drop(columns=["BELAGSART", "road_width", "OBJEKTART",
                             "KUNSTBAUTE", "GDB-Code", "road_len", "id"],
                    inplace=True, errors="ignore")

    roi_4326 = roi_in_aoi.to_crs(epsg=4326)
    roi_4326 = test_valid_geom(roi_4326, correct=True,
                               gdf_obj_name="reprojected roads")
    w, s, e, n = roi_4326.total_bounds

    logger.info("Generating the tiles...")
    tms = WebMercatorQuad
    feats = [tms.feature(t, projected=True)
             for t in tms.tiles(w, s, e, n, zooms=[zoom_level])]
    tiles = GeoDataFrame.from_features(feats, crs="EPSG:3857")
    tiles["title"] = [f["properties"]["title"] for f in feats]

    roi_3857 = roi_in_aoi.to_crs(epsg=3857)
    test_crs("EPSG:3857", roi_3857.crs)

    hit = sjoin(tiles, roi_3857, how="inner")
    bad_titles = hit[hit["OBJECTID"].isin(excluded_ids)]["title"] \
        .unique().tolist()
    logger.warning(f"{len(bad_titles)} tiles are to be excluded, because "
                   "they contain unknown roads.")

    hit = hit.drop_duplicates("title")
    hit = hit.drop(columns=["grid_name", "grid_crs", "index_right"],
                   errors="ignore").reset_index(drop=True)
    keep = hit[~hit["title"].isin(bad_titles)].copy()
    keep.drop(columns=["OBJECTID"], inplace=True, errors="ignore")
    keep.reset_index(drop=True, inplace=True)
    logger.warning(f"{len(hit) - len(keep)} have been excluded.")

    # formatted "(x, y, z)" id from the digits of the title's 3 parts
    xyz = [[re.sub(r"[^0-9]", "", part) for part in t.split(",")]
           for t in keep["title"]]
    keep["id"] = [f"({x}, {y}, {z})" for x, y, z in xyz]
    keep = GeoDataFrame(keep, crs="EPSG:3857")

    logger.info(f"{len(keep)} tiles can be considered.")
    logger.success("Done determining the tiles!")
    return keep


def generate_labels(non_forest_roads: GeoDataFrame,
                    tiles_4326: GeoDataFrame,
                    ok_tiles: GeoDataFrame | None = None,
                    restricted_aoi_training: GeoDataFrame | None = None,
                    zoom_level: int = 18):
    """Stage 3: tag labels with CATEGORY/SUPERCATEGORY and split them into
    ground-truth (on considered tiles) vs other labels.

    Reference behavior: prepare_data_obj_detec.py:288-370. Returns
    (gt_labels, oth_labels) in EPSG:4326.
    """
    tiles = tiles_4326

    if ok_tiles is not None:
        logger.info("Only the tiles judged ok (zoom 18 verification) are used.")
        verif = ok_tiles.replace("-", "0.5")
        verif = verif[~verif["OK"].isna()].copy()
        verif["OK"] = verif["OK"].astype(float)
        ok = verif[verif["OK"] >= 0.5]
        if zoom_level == 18:
            tiles = GeoDataFrame(
                tiles.merge(ok[["title", "OK"]], how="inner", on="title"),
                crs=tiles.crs)
        elif zoom_level > 18:
            tiles = sjoin(tiles, ok[["OK", "geometry"]], how="inner",
                          predicate="within")
            tiles.drop(columns=["index_right"], inplace=True)
        else:
            logger.warning("Ok-tile selection below zoom 18 not available; "
                           "no tile selection.")

    if restricted_aoi_training is not None:
        logger.info("A subset of the AOI is used for the training.")
        raoi = restricted_aoi_training.to_crs(epsg=4326)
        cols = [c for c in ("KBNUM", "geometry") if c in raoi.columns]
        tiles = sjoin(tiles, raoi[cols], how="inner")
        tiles.drop(columns=["index_right"], inplace=True)

    labels = non_forest_roads[
        non_forest_roads["BELAGSART"].isin(BELAGSART_TO_KEEP)].copy()
    labels["CATEGORY"] = [determine_category(b)
                          for b in labels["BELAGSART"].values]
    labels["SUPERCATEGORY"] = "road"
    labels = labels.to_crs(epsg=4326)
    labels = test_valid_geom(labels, correct=True, gdf_obj_name="labels")

    logger.info("Labels on tiles...")
    test_crs(labels.crs, tiles.crs)
    gt = sjoin(labels, tiles, how="inner", predicate="intersects")

    # any tile touching a surface-unknown road disqualifies all its labels
    bad_tiles = gt[gt["CATEGORY"] == "else"]["id"].unique().tolist()
    gt = gt[~gt["id"].isin(bad_tiles)]

    # an object intersecting several tiles must be counted once
    gt = gt[list(labels.columns)]
    gt = gt.drop_duplicates()
    oth = labels[~labels.index.isin(gt.index)]

    assert len(labels) == len(gt) + len(oth), (
        "Something went wrong when splitting labels into Ground Truth and "
        f"Other labels: total={len(labels)} GT={len(gt)} OTH={len(oth)}")

    n_art = int((gt["BELAGSART"] == 100).sum())
    n_nat = int((gt["BELAGSART"] == 200).sum())
    logger.info(f"{len(gt)} labels are saved as ground truth "
                f"({n_art} artificial, {n_nat} natural); "
                f"{len(oth)} as other labels.")
    logger.success("Done generating the labels for the object detector!")
    return GeoDataFrame(gt, crs="EPSG:4326"), GeoDataFrame(oth,
                                                           crs="EPSG:4326")


# ---------------------------------------------------------------------------
# driver: same YAML block schema as the reference script

def run(cfg: dict, timings: dict | None = None) -> list[str]:
    """Execute the configured subset of the three tasks and write their
    files; returns the paths written. ``cfg`` is the
    ``prepare_data_obj_detec.py`` YAML block. A ``timings`` dict receives
    each stage's seconds ("surfaces", "tiles", "labels", writing its files
    included)."""
    timings = {} if timings is None else timings
    tasks = cfg["tasks"]
    do_surfaces = tasks["determine_roads_surfaces"]
    do_tiles = tasks["generate_tiles_info"]
    do_labels = tasks["generate_labels"]
    if not (do_surfaces or do_tiles or do_labels):
        logger.info("Nothing to do. Exiting!")
        return []

    inp = cfg["input"]
    input_dir = inp["input_folder"]
    files = inp["input_files"]
    out_dir = cfg["output_folder"]
    path_shp = ensure_dir_exists(os.path.join(out_dir, "shapefiles_gpkg"))
    path_json = ensure_dir_exists(os.path.join(out_dir, "json_inputs"))

    roads_parameters = read_excel(os.path.join(input_dir,
                                               files["roads_param"]))
    manifest = Manifest()

    non_forest_roads = None
    t0 = time.perf_counter()
    if do_surfaces:
        roads = read_file(os.path.join(input_dir, files["roads"]))
        forests = read_file(os.path.join(input_dir, files["forests"]))
        non_forest_roads = determine_road_surfaces(roads, forests,
                                                   roads_parameters)
        p = os.path.join(path_shp, "roads_for_OD.shp")
        write_file(non_forest_roads, p)
        manifest.add(p)
        timings["surfaces"] = time.perf_counter() - t0
    elif do_tiles or do_labels:
        proc = cfg["processed_input"]
        non_forest_roads = read_file(
            os.path.join(path_shp, proc["roads_for_labels"]),
            layer=proc.get("layer"))

    tiles = None
    t0 = time.perf_counter()
    if do_tiles:
        aoi = read_file(os.path.join(input_dir, files["aoi"]))
        zoom = cfg["zoom_level"]
        tiles = generate_tiles_info(non_forest_roads, aoi, roads_parameters,
                                    zoom)
        tiles_4326 = tiles.to_crs(epsg=4326)
        p = os.path.join(path_json, "tiles_aoi.geojson")
        write_file(tiles_4326, p, driver="GeoJSON")
        manifest.add(p)
        timings["tiles"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if do_labels:
        if tiles is not None:
            tiles_4326 = tiles.to_crs(epsg=4326)
        else:
            tiles_4326 = read_file(os.path.join(path_json,
                                                "tiles_aoi.geojson"))
            tiles_4326 = tiles_4326[["title", "id", "geometry"]]

        ok_tiles = None
        if cfg.get("ok_tiles"):
            ok_tiles = read_file(os.path.join(out_dir, cfg["ok_tiles"]))
        raoi = None
        if files.get("restricted_aoi_training"):
            raoi = read_file(os.path.join(input_dir,
                                          files["restricted_aoi_training"]))

        gt, oth = generate_labels(non_forest_roads, tiles_4326, ok_tiles,
                                  raoi, cfg.get("zoom_level", 18))
        p = os.path.join(path_json, "ground_truth_labels.geojson")
        write_file(gt, p, driver="GeoJSON")
        manifest.add(p)
        if not oth.empty:
            p = os.path.join(path_json, "other_labels.geojson")
            write_file(oth, p, driver="GeoJSON")
            manifest.add(p)
        timings["labels"] = time.perf_counter() - t0

    manifest.log()
    return manifest.files


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="Generates COCO-ready datasets for road-surface "
                    "object detection.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    args = parser.parse_args(argv)
    logger.info(f"Using {args.config_file} as config file.")
    run(load_script_config(args.config_file, "prepare_data_obj_detec.py"))
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
