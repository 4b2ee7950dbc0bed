"""The statistical branch's data preparation: road polygons without any
overlap (between classes and within one) and the restricted AOI.

A copy of the reference package's ``pipeline/stats_prep.py`` (the upstream
statistical_analysis/prepare_data.py: the same YAML block and the same
files): the detection branch's line-to-polygon machinery, which here also
removes the overlap between roads of the same class, and the restricted
AOI, the union of the roads buffered by (max width + 1)/2 minus the
forests buffered by 3 m. Writes ``roads_polygons_stats.shp`` and
``restricted_AOI.shp``. Host work only (pandas and the C++ geometry core,
whose union keeps the holes of the fields a road network encloses: ROADMAP
Queue C, fault (a)). Entry point: ``python -m
roadsurf_tpu_torch.pipeline.stats_prep config/config_stats.yaml`` (its
``prepare_data.py`` block).
"""

from __future__ import annotations

import argparse
import os
import time

from ..geom.cleanup import (intersecting_pairs, keep_largest_part,
                            polygons_diff_without_artifacts)
from ..geom.table import GeoDataFrame, overlay
from ..io import read_excel, read_file, write_file
from ..utils.config import load_script_config
from ..utils.logging import logger
from ..utils.misc import Manifest, ensure_dir_exists, test_crs
from .label_prep import BELAGSART_TO_KEEP, KUNSTBAUTE_TO_KEEP, NOT_ROAD, \
    _DROP_COLS


def determine_road_surfaces_stats(roads, forests, roads_parameters, aoi,
                                  debug_mode: bool = False):
    """Lines to polygons, with the overlap removed between roads of
    different width classes and between same-class neighbours; returns
    (the polygons outside the forests, the road lines in the AOI)."""
    roi = roads[~roads["OBJEKTART"].isin(NOT_ROAD)]
    uncovered = roi[roi["KUNSTBAUTE"].isin(KUNSTBAUTE_TO_KEEP)].copy()
    params = roads_parameters[~roads_parameters["Width"].isna()].copy()
    params.drop_duplicates(subset="GDB-Code", inplace=True)
    joined = GeoDataFrame(
        uncovered.merge(params[["GDB-Code", "Width"]], how="inner",
                        left_on="OBJEKTART", right_on="GDB-Code"),
        crs=roads.crs)
    joined.drop(columns=_DROP_COLS, inplace=True, errors="ignore")
    joined = GeoDataFrame(
        joined[joined["BELAGSART"].isin(BELAGSART_TO_KEEP)], crs=roads.crs)

    aoi_geom = GeoDataFrame({"id": [0],
                             "geometry": [aoi.geometry.unary_union]},
                            crs="EPSG:2056")
    test_crs(joined.crs, aoi_geom.crs)
    in_aoi = overlay(joined, aoi_geom, how="intersection")
    if debug_mode:
        in_aoi = GeoDataFrame(in_aoi.iloc[1:100].copy(), crs=in_aoi.crs)

    in_aoi["road_len"] = in_aoi.length.round(3)

    logger.info("Buffering the roads...")
    buffered = in_aoi.copy()
    polys = buffered.buffer(buffered["Width"] / 2, cap_style=2)
    buffered["geometry"] = [keep_largest_part(g) for g in polys.values]

    logger.info("Removing overlap between roads of different classes...")
    pairs = intersecting_pairs(buffered, ["OBJECTID", "OBJEKTART"])
    rank1 = pairs["OBJEKTART_1"].astype(float).where(
        pairs["OBJEKTART_1"] != 20, 8.5)
    rank2 = pairs["OBJEKTART_2"].astype(float).where(
        pairs["OBJEKTART_2"] != 20, 8.5)
    cuts = pairs[rank1 < rank2].copy()
    cuts["_rank"] = rank1[rank1 < rank2]
    cuts.sort_values(by="_rank", inplace=True, kind="stable",
                     ignore_index=True)

    corr1 = buffered.copy()
    for row in cuts.itertuples():
        p1 = corr1.index[corr1["OBJECTID"] == row.OBJECTID_1].values
        p2 = corr1.index[corr1["OBJECTID"] == row.OBJECTID_2].values
        if len(p1) and len(p2):
            corr1 = polygons_diff_without_artifacts(corr1, int(p1[0]),
                                                    int(p2[0]))
    corr1 = GeoDataFrame(corr1)
    corr1.drop(columns=["saved_geom"], inplace=True, errors="ignore")

    logger.info("Removing overlap between roads of the same class...")
    pairs2 = intersecting_pairs(corr1, ["OBJECTID"])
    # drop the symmetric duplicate of each undirected pair
    seen = set()
    keep_rows = []
    for idx, row in pairs2.iterrows():
        key = frozenset((row["OBJECTID_1"], row["OBJECTID_2"]))
        if key in seen:
            continue
        seen.add(key)
        keep_rows.append(idx)
    pairs2 = pairs2.loc[keep_rows]

    corr2 = GeoDataFrame(corr1.copy())
    for row in pairs2.itertuples():
        p1 = corr2.index[corr2["OBJECTID"] == row.OBJECTID_1].values
        p2 = corr2.index[corr2["OBJECTID"] == row.OBJECTID_2].values
        if len(p1) and len(p2):
            corr2 = polygons_diff_without_artifacts(corr2, int(p1[0]),
                                                    int(p2[0]))
    corr2 = GeoDataFrame(corr2)
    corr2.drop(columns=["saved_geom"], inplace=True, errors="ignore")
    corr2.set_crs(epsg=2056, inplace=True)

    logger.info("Excluding roads under forest canopy...")
    test_crs(corr2.crs, forests.crs)
    fb = forests.copy()
    fb["geometry"] = fb.buffer(3)
    cols = [c for c in ("UUID", "geometry") if c in fb.columns]
    non_forest = overlay(corr2, fb[cols], how="difference")
    non_forest.drop(columns=["UUID", "GDB-Code", "id"], inplace=True,
                    errors="ignore")
    non_forest.rename(columns={"Width": "road_width"}, inplace=True)
    return non_forest, in_aoi


def determine_restricted_aoi(roads_in_aoi, forests, roads_parameters):
    """The union of the roads buffered by (max width + 1)/2, minus the
    forests buffered by 3 m."""
    width = (roads_parameters["Width"].max() + 1) / 2
    buffered = roads_in_aoi.copy()
    buffered["geometry"] = buffered.buffer(width)
    union = buffered.geometry.unary_union
    parts = list(getattr(union, "geoms", [union]))
    aoi_roads = GeoDataFrame({"geometry": parts}, crs="EPSG:2056")

    test_crs(aoi_roads.crs, forests.crs)
    fb = forests.copy()
    fb["geometry"] = fb.buffer(3)
    cols = [c for c in ("UUID", "geometry") if c in fb.columns]
    return overlay(aoi_roads, fb[cols], how="difference")


def run(cfg: dict) -> list[str]:
    """Execute the ``prepare_data.py`` YAML block (config_stats.yaml);
    returns the paths written."""
    tasks = cfg["tasks"]
    inp = cfg["input"]
    files = inp["input_files"]
    input_dir = inp["input_folder"]
    out_dir = cfg["output_folder"]
    debug = bool(cfg.get("debug_mode", False))
    manifest = Manifest()

    roads = read_file(os.path.join(input_dir, files["roads"]))
    forests = read_file(os.path.join(input_dir, files["forests"]))
    aoi = read_file(os.path.join(input_dir, files["aoi"]))
    params = read_excel(os.path.join(input_dir, files["roads_param"]))

    path_shp = ensure_dir_exists(os.path.join(out_dir, "shapefiles_gpkg"))

    non_forest = roads_in_aoi = None
    if tasks.get("determine_roads_surfaces"):
        non_forest, roads_in_aoi = determine_road_surfaces_stats(
            roads, forests, params, aoi, debug)
        p = os.path.join(path_shp, "roads_polygons_stats.shp")
        write_file(non_forest, p)
        manifest.add(p)

    if tasks.get("determine_restricted_AOI"):
        if roads_in_aoi is None:
            _, roads_in_aoi = determine_road_surfaces_stats(
                roads, forests, params, aoi, debug)
        raoi = determine_restricted_aoi(roads_in_aoi, forests, params)
        p = os.path.join(path_shp, "restricted_AOI.shp")
        write_file(raoi, p)
        manifest.add(p)

    manifest.log()
    return manifest.files


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="Prepares overlap-free road polygons and the "
                    "restricted AOI for the statistical analysis.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    args = parser.parse_args(argv)
    logger.info(f"Using {args.config_file} as config file.")
    run(load_script_config(args.config_file, "prepare_data.py"))
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
