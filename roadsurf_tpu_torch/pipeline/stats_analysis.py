"""Statistical analysis of road-surface pixels (the reference's abandoned
classical-ML branch).

A copy of the reference package's ``pipeline/stats_analysis.py`` (the
upstream statistical_analysis.py: the same YAML block and the same files):
per-road pixel extraction from the z18 tiles, per-road per-band statistics
or a zonal-statistics path, band ratios and the VgNIR-BI index, an optional
class-balancing subsample, boxplots, Kolmogorov-Smirnov road-against-class
tests, and PCAs of the pixels and of the roads' per-band statistics. The
PCAs run in PyTorch on ``device`` (``stats/pca.py``); the rest is host work
(pandas, scipy, matplotlib, the C++ fill). Entry point: ``python -m
roadsurf_tpu_torch.pipeline.stats_analysis config/config_stats.yaml
[--device cpu]`` (its ``statistical_analysis.py`` block).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import pandas as pd

from ..geom.table import GeoDataFrame, sjoin
from ..io import read_file
from ..stats.descriptive import (compare_histograms, get_df_stats_groupby,
                                 get_df_stats_no_group)
from ..stats.pca import _save_webp, pca_procedure
from ..stats.pixels import get_pixel_values, zonal_stats
from ..tiles.grid import parse_tile_id
from ..utils.config import load_script_config
from ..utils.device import resolve_device
from ..utils.logging import logger
from ..utils.misc import Manifest, ensure_dir_exists, test_crs

BANDS = [1, 2, 3, 4]
BANDS_STR = ["red", "green", "blue", "NIR"]
RATIO_NAMES = {"1/2": "R/G", "1/3": "R/B", "1/4": "R/NIR",
               "2/3": "G/B", "2/4": "G/NIR", "3/4": "B/NIR"}


def im_of_hist_comp(band: str, roads_subset: pd.DataFrame,
                    pixels: pd.DataFrame, out_dir: str,
                    prefix: str = "") -> list[str]:
    """Histogram comparison images: each road's pixels against its
    class's pixels."""
    written = []
    for row in roads_subset.itertuples():
        cls_pixels = pixels.loc[pixels["road_type"] == row.road_type, band]
        road_pixels = pixels.loc[pixels["road_id"] == row.road_id, band]
        fig = compare_histograms(
            {f"road {row.road_id}": road_pixels,
             f"{row.road_type} roads": cls_pixels},
            graph_title=f"Road {row.road_id} vs {row.road_type} on {band}",
            axis_label="density")
        p = os.path.join(out_dir,
                         f"{prefix}hist_{band}_road_{row.road_id}.jpg")
        fig.savefig(p, bbox_inches="tight")
        import matplotlib.pyplot as plt
        plt.close(fig)
        written.append(p)
    return written


def extract_pixels_per_road(roads_3857: GeoDataFrame,
                            tiles_3857: GeoDataFrame,
                            bands=BANDS) -> pd.DataFrame:
    """Per-road per-band pixel values from every tile the road crosses."""
    assert not roads_3857["OBJECTID"].duplicated().any(), \
        "roads must be unique per OBJECTID (fuse multipolygons first)"
    test_crs(roads_3857.crs, tiles_3857.crs)
    hit = sjoin(tiles_3857, roads_3857[["OBJECTID", "geometry"]],
                how="inner")
    hit = hit.drop_duplicates(subset=["id", "OBJECTID"])

    geom_by_id = dict(zip(roads_3857["OBJECTID"], roads_3857.geometry))
    # one frame a tile, concatenated once at the end: the reference grows
    # one frame a road and a tile, quadratic in the pixel count; the rows,
    # their order and the index are the same
    pieces = []
    for oid, tile_paths in hit.groupby("OBJECTID")["filepath"]:
        for tp in tile_paths:
            if not os.path.exists(tp):
                continue
            vals = get_pixel_values(geom_by_id[oid], tp, bands, road_id=oid)
            if len(vals.columns):
                pieces.append(vals)
    if not pieces:
        return pd.DataFrame()
    return pd.concat(pieces, ignore_index=True)


def add_band_ratios(pixels: pd.DataFrame) -> list[str]:
    """The band ratios R/G … B/NIR (NaN→0, inf→1) and VgNIR-BI."""
    for b in BANDS:
        for sb in range(b + 1, max(BANDS) + 1):
            name = RATIO_NAMES[f"{b}/{sb}"]
            with np.errstate(divide="ignore", invalid="ignore"):
                r = pixels[f"band{b}"].astype("float64") \
                    / pixels[f"band{sb}"].astype("float64")
            r = r.round(3)
            r[np.isnan(r)] = 0
            r[~np.isfinite(r)] = 1
            pixels[name] = r
    g = pixels["band2"].astype("float64")
    nir = pixels["band4"].astype("float64")
    with np.errstate(divide="ignore", invalid="ignore"):
        v = (g - nir) / (g + nir)
    pixels["VgNIR-BI"] = v.round(5)
    return list(RATIO_NAMES.values())


def run(cfg: dict, device="cuda", figures: bool = True,
        timings: dict | None = None) -> list[str]:
    """Execute the ``statistical_analysis.py`` YAML block
    (config_stats.yaml); returns the paths written. The PCAs run on
    ``device`` (the card unless the caller asks for the CPU). With
    ``figures`` off, no figure is drawn (no boxplots, no KS histograms, the
    PCAs' tables alone) and matplotlib is not needed. A ``timings`` dict
    receives each stage's seconds."""
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    tic = time.perf_counter()
    debug = bool(cfg.get("debug_mode", False))
    use_zonal = bool(cfg.get("use_zonal_stats", False))
    balance = bool(cfg.get("correct_balance", False))
    proc = cfg["processed"]
    proc_folder = proc["processed_folder"]
    files = proc["input_files"]
    final_folder = cfg["final_folder"]
    param = cfg.get("param", {})
    count_threshold = param.get("pixel_threshold", 10)
    max_moe = param.get("max_margin_of_interest", 12.5)

    manifest = Manifest()
    tables_dir = ensure_dir_exists(os.path.join(final_folder, "tables"))
    images_dir = ensure_dir_exists(os.path.join(final_folder, "images"))

    roads = read_file(os.path.join(proc_folder, files["roads"]))
    tiles_info = read_file(os.path.join(proc_folder, files["tiles"]))
    tiles_dir = os.path.join(proc_folder, files["images"])

    if debug:
        tiles_info = GeoDataFrame(tiles_info.iloc[1:500].copy(),
                                  crs=tiles_info.crs)
        logger.warning("Debug mode: only 500 tiles processed.")

    if (~roads.is_valid).any():
        logger.error(f"{int((~roads.is_valid).sum())} invalid road "
                     "geometries.")
        sys.exit(1)

    roads_3857 = roads.to_crs(epsg=3857)
    bad = ~roads_3857.is_valid
    if bad.any():
        logger.warning("Correcting invalid reprojected geometries with "
                       "buffer(0)...")
        roads_3857.loc[bad, "geometry"] = [
            g.buffer(0) for g in roads_3857.loc[bad, "geometry"].values]

    tiles_3857 = tiles_info.to_crs(epsg=3857)
    tiles_3857["filepath"] = [
        os.path.join(tiles_dir,
                     f"{t.z}_{t.x}_{t.y}.tif")
        for t in (parse_tile_id(i) for i in tiles_3857["id"])]

    roads_base = pd.DataFrame(
        roads_3857[["OBJECTID", "BELAGSART", "road_width"]]).rename(
        columns={"OBJECTID": "road_id", "BELAGSART": "road_type"})

    timings["read"] = time.perf_counter() - tic
    logger.info("Extracting road pixels...")
    tic = time.perf_counter()
    pixels = extract_pixels_per_road(roads_3857, tiles_3857)
    timings["extract"] = time.perf_counter() - tic
    if not len(pixels):
        logger.error("no pixels extracted; check tile imagery")
        sys.exit(1)
    pixels = pd.merge(pixels, roads_base, on="road_id")

    logger.info("Determining per-road statistics...")
    tic = time.perf_counter()
    if use_zonal:
        rows = []
        hit = sjoin(tiles_3857, roads_3857[["OBJECTID", "BELAGSART",
                                            "geometry"]], how="inner")
        geom_by_id = dict(zip(roads_3857["OBJECTID"], roads_3857.geometry))
        for r in hit.itertuples():
            if not os.path.exists(r.filepath):
                continue
            for band in BANDS:
                st = zonal_stats(geom_by_id[r.OBJECTID], r.filepath,
                                 band=band, nodata=0)[0]
                st.update({"band": band, "road_id": r.OBJECTID,
                           "road_type": r.BELAGSART, "tile_id": r.id})
                rows.append(st)
        roads_stats = pd.DataFrame(rows)
        roads_stats_df = roads_stats
        roads_stats_filtered = roads_stats
    else:
        roads_stats = roads_base.copy()
        for band in BANDS:
            sub = get_df_stats_groupby(pixels, f"band{band}", ["road_id"],
                                       suffix=f"_{band}")
            sub["road_id"] = sub.index
            sub.reset_index(drop=True, inplace=True)
            roads_stats = pd.merge(roads_stats, sub, on="road_id")
        roads_stats["count"] = roads_stats["count_1"]
        roads_stats.drop(columns=[f"count_{b}" for b in BANDS],
                         inplace=True)
        n_large = sum(int((roads_stats[f"margin_{b}"] > max_moe).sum())
                      for b in BANDS)
        if n_large:
            logger.warning(f"{n_large} margins of error larger than "
                           f"{max_moe} pixel values.")

        roads_stats_df = roads_stats
        p = os.path.join(ensure_dir_exists(
            os.path.join(proc_folder, "tables")), "stats_roads.csv")
        roads_stats_df.to_csv(p, index=False)
        manifest.add(p)

        keep = (roads_stats_df["count"] > count_threshold) & (
            (roads_stats_df["margin_1"] < max_moe)
            | (roads_stats_df["margin_2"] < max_moe)
            | (roads_stats_df["margin_3"] < max_moe)
            | (roads_stats_df["margin_4"] < max_moe))
        roads_stats_filtered = roads_stats_df[keep].drop(
            columns=[f"margin_{b}" for b in BANDS] + ["count"])
        logger.info(f"{len(roads_stats_df) - len(roads_stats_filtered)} of "
                    f"{len(roads_stats_df)} roads dropped (pixel count or "
                    "margin of error).")

    timings["road_stats"] = time.perf_counter() - tic
    logger.info("Calculating band ratios + VgNIR-BI...")
    tic = time.perf_counter()
    bands_ratio = add_band_ratios(pixels)

    logger.info("Statistics per band and cover type...")
    cover_stats: dict = {"cover": [], "band": [], "min": [], "max": [],
                         "mean": [], "median": [], "std": [], "margin": [],
                         "count": []}
    for cover in pixels["road_type"].unique().tolist():
        for band in BANDS:
            sub = pixels[pixels["road_type"] == cover]
            cover_stats["cover"].append(cover)
            cover_stats["band"].append(band)
            cover_stats = get_df_stats_no_group(sub, f"band{band}",
                                                cover_stats)
    cover_df = pd.DataFrame(cover_stats)
    for c in ("mean", "std", "margin"):
        cover_df[c] = cover_df[c].round(1)
    p = os.path.join(tables_dir, "statistics_roads_by_type.csv")
    cover_df.to_csv(p, index=False)
    manifest.add(p)

    prefix = ""
    if balance:
        logger.info("Balancing classes by subsampling artificial roads...")
        nat_p = pixels[pixels["road_type"] == 200]
        nat_s = roads_stats_filtered[
            roads_stats_filtered["road_type"] == 200]
        art_p = pixels[pixels["road_type"] == 100].reset_index(drop=True)
        art_s = roads_stats_filtered[
            roads_stats_filtered["road_type"] == 100].reset_index(drop=True)
        if len(art_p) and len(art_s):
            art_p = art_p.sample(frac=len(nat_p) / len(art_p),
                                 random_state=1)
            art_s = art_s.sample(frac=len(nat_s) / len(art_s),
                                 random_state=9)
        pixels = pd.concat([art_p, nat_p], ignore_index=True)
        roads_stats_filtered = pd.concat([art_s, nat_s], ignore_index=True)
        prefix = "balanced_"

    # reader-friendly names
    pixels = pixels.rename(columns={"band1": "red", "band2": "green",
                                    "band3": "blue", "band4": "NIR"})
    rename = {}
    for b in BANDS:
        for stat in ("max_", "min_", "mean_", "median_", "std_"):
            rename[stat + str(b)] = stat + BANDS_STR[b - 1]
    roads_stats_filtered = roads_stats_filtered.rename(columns=rename)
    pixels["road_type"] = pixels["road_type"].map(
        {100: "artificial", 200: "natural"})
    roads_stats_filtered = roads_stats_filtered.copy()
    roads_stats_filtered["road_type"] = roads_stats_filtered[
        "road_type"].map({100: "artificial", 200: "natural"})

    timings["cover_stats"] = time.perf_counter() - tic
    tic = time.perf_counter()
    if figures and param.get("make_boxplots", True):
        logger.info("Boxplots...")
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        def box(df, cols, fname, logy=False, figsize=(12, 8)):
            axes = df[cols + ["road_type"]].plot.box(
                by="road_type", figsize=figsize, grid=True, logy=logy,
                title="Repartition of the values for the pixels")
            fig = np.asarray(axes).ravel()[0].get_figure()
            p = os.path.join(images_dir, fname)
            _save_webp(fig, p)
            plt.close(fig)
            manifest.add(p)

        box(pixels, BANDS_STR, f"{prefix}boxplot_pixel_in_bands.webp")
        box(pixels, bands_ratio[:3],
            f"{prefix}boxplot_pixel_in_bands_ratio_part1.webp", logy=True,
            figsize=(10, 8))
        box(pixels, bands_ratio[3:],
            f"{prefix}boxplot_pixel_in_bands_ratio_part2.webp", logy=True)
        box(pixels, ["VgNIR-BI"], f"{prefix}boxplot_pixel_by_VgNIR_BI.webp",
            figsize=(2.75, 8))
        for band in BANDS_STR:
            cols = [s + band for s in ("max_", "min_", "mean_", "median_",
                                       "std_")]
            box(roads_stats_filtered, cols,
                f"{prefix}boxplot_stats_band_{band}.webp", figsize=(15, 8))

    timings["boxplots"] = time.perf_counter() - tic
    tic = time.perf_counter()
    if param.get("do_ks_test", False):
        logger.info("Kolmogorov-Smirnov tests...")
        from scipy.stats import kstest
        for band in BANDS_STR:
            pvals, dvals = [], []
            for row in roads_stats_filtered.itertuples():
                general = pixels.loc[pixels["road_type"] == row.road_type,
                                     [band, "road_id"]]
                road_vals = general.loc[general["road_id"] == row.road_id,
                                        band]
                ks = kstest(road_vals, general[band])
                pvals.append(float(f"{ks.pvalue:0.3e}"))
                dvals.append(round(float(ks.statistic), 3))
            roads_stats_filtered[f"ks_p_{band}"] = pvals
            roads_stats_filtered[f"ks_D_{band}"] = dvals
        p = os.path.join(tables_dir, "ks_test.csv")
        roads_stats_filtered.to_csv(p)
        manifest.add(p)

        hist_dir = ensure_dir_exists(os.path.join(images_dir, "histograms"))
        for band in BANDS_STR:
            for cover in roads_stats_filtered["road_type"] \
                    .unique().tolist():
                sel = roads_stats_filtered[
                    roads_stats_filtered["road_type"] == cover]
                n_sig = int((sel[f"ks_p_{band}"] > 0.05).sum())
                logger.info(f"{n_sig}/{len(sel)} {cover} roads with "
                            f"p>0.05 on {band}.")
                if not figures:
                    continue
                mx = roads_stats_filtered[f"ks_p_{band}"].max()
                hi = sel[sel[f"ks_p_{band}"] > mx - mx / 100].head(5)
                for f in im_of_hist_comp(band, hi, pixels, hist_dir,
                                         "high_"):
                    manifest.add(f)
                mn = roads_stats_filtered[f"ks_p_{band}"].min()
                lo = sel[sel[f"ks_p_{band}"] <= mn + mn / 100].head(5)
                for f in im_of_hist_comp(band, lo, pixels, hist_dir,
                                         "low_"):
                    manifest.add(f)

    timings["ks_test"] = time.perf_counter() - tic
    tic = time.perf_counter()
    if param.get("make_pca", True):
        logger.info("PCA of the pixel values...")
        features = BANDS_STR + bands_ratio + ["VgNIR-BI", "road_width"]
        for f in pca_procedure(
                pixels.dropna(subset=features), features, "road_type",
                tables_dir, images_dir, f"{prefix}PCA_pixels_",
                "PCA for the values of the pixels on each band",
                device=dev, figures=figures):
            manifest.add(f)

        logger.info("PCA of the road stats per band...")
        for band in BANDS_STR:
            features = [s + band for s in ("max_", "min_", "mean_",
                                           "median_", "std_")] \
                + ["road_width"]
            for f in pca_procedure(
                    roads_stats_filtered.dropna(subset=features), features,
                    "road_type", tables_dir, images_dir,
                    f"{prefix}PCA_stats_band_{band}_",
                    f"PCA of the statistics of the roads on the {band} "
                    "band", device=dev, figures=figures):
                manifest.add(f)

    timings["pca"] = time.perf_counter() - tic
    manifest.log()
    return manifest.files


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="Analyzes road pixel statistics: stats tables, band "
                    "ratios, boxplots, KS tests, PCAs.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    parser.add_argument("--device", default="cuda",
                        help="where the PCAs run (default: the card)")
    args = parser.parse_args(argv)
    logger.info(f"Using {args.config_file} as config file.")
    run(load_script_config(args.config_file, "statistical_analysis.py"),
        device=args.device)
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
