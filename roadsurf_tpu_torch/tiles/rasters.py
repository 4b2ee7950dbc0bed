"""Raster utilities of the DEM chain (a copy of the reference package's
``tiles/rasters.py``, the upstream fct_rasters.py): ``download_tiles``
fetches a list of .tif tiles (skip if on disk, exit on any failure),
``make_mosaic`` merges georeferenced tiles into one raster (first wins on
overlap, as rasterio.merge) and ``dem_zonal_stats`` gives each road its
elevation statistics over the mosaic. Host work (numpy, the C++ fill).

Entry point, the reference's ``scripts/dem_zonal_stats.py``:
``python -m roadsurf_tpu_torch.tiles.rasters [--generate-mosaic] ...``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import urllib.request

import numpy as np

from ..io.geotiff import read_geotiff, write_geotiff
from ..utils.logging import logger


def download_tiles(tiles_list: list[str], directory: str = "",
                   crs: str = "2056", save_metadata: bool = False,
                   overwrite: bool = False, opener=None) -> list[str]:
    """Download .tif tiles from a URL list into ``directory``, skipping
    files already there; exit(1) if any download fails. ``opener(url)``
    returns a tile's bytes (default: urllib)."""
    successful, written = [], []
    get = opener or (lambda url: urllib.request.urlopen(url).read())
    for url in tiles_list:
        if not url.endswith(".tif"):
            raise Exception("Filename must end with .tif")
        name = url.split("/")[-1]
        path = os.path.join(directory, name)
        if os.path.exists(path) and not overwrite:
            successful.append(url)
            written.append(name)
            continue
        try:
            blob = get(url)
        except Exception as e:
            logger.error(f"download failed for {url}: {e}")
            continue
        with open(path, "wb") as f:
            f.write(blob)
        successful.append(url)
        written.append(name)

    if set(tiles_list) != set(successful):
        logger.error("Some files were not successfully downloaded:")
        for url in tiles_list:
            if url not in successful:
                logger.error(url)
        sys.exit(1)
    return written


def make_mosaic(directory: str, filenames: list[str],
                out_path: str) -> str:
    """Merge georeferenced tiles into one raster (first wins on overlap)."""
    rasters = [read_geotiff(os.path.join(directory, f)) for f in filenames]
    if not rasters:
        raise ValueError("no tiles to mosaic")
    sx, sy = rasters[0].pixel_size
    epsg = rasters[0].epsg
    west = min(r.bounds[0] for r in rasters)
    south = min(r.bounds[1] for r in rasters)
    east = max(r.bounds[2] for r in rasters)
    north = max(r.bounds[3] for r in rasters)
    W = int(round((east - west) / sx))
    H = int(round((north - south) / sy))
    C = rasters[0].data.shape[2]
    nodata = rasters[0].nodata if rasters[0].nodata is not None else 0
    mosaic = np.full((H, W, C), nodata, rasters[0].data.dtype)
    for r in rasters:
        col = int(round((r.bounds[0] - west) / sx))
        row = int(round((north - r.bounds[3]) / sy))
        h, w = r.data.shape[:2]
        region = mosaic[row:row + h, col:col + w]
        fill = region == nodata if nodata is not None else \
            np.ones_like(region, bool)
        region[fill] = r.data[fill]
    write_geotiff(out_path, mosaic, (west, south, east, north), epsg=epsg,
                  nodata=float(nodata))
    return out_path


def dem_zonal_stats(mosaic_path: str, roads_gdf, nodata: float = -9999,
                    stats=("min", "max", "mean", "median", "std")):
    """Each road's elevation statistics over a DEM mosaic; returns the
    roads' frame with the statistics' columns appended."""
    from ..stats.pixels import _geometry_mask

    r = read_geotiff(mosaic_path)
    rows = []
    for geom in roads_gdf.geometry.values:
        mask = _geometry_mask(geom, r).astype(bool)
        vals = r.data[:, :, 0][mask].astype(np.float64)
        vals = vals[vals != nodata]
        if len(vals):
            rows.append({s: float(getattr(np, s)(vals)) if s != "median"
                         else float(np.median(vals)) for s in stats})
        else:
            rows.append({s: None for s in stats})
    out = roads_gdf.reset_index(drop=True).copy()
    for s in stats:
        out[s] = [row[s] for row in rows]
    return out


def run(initial_folder: str = "data/DEM", processed_folder: str = "outputs",
        final_folder: str = "outputs/final",
        url_file: str = "ch.swisstopo.swissalti3d_res2m.csv",
        roads: str = "shp_gpkg/types_from_detections.shp",
        generate_mosaic: bool = False, skip_zonal_stats: bool = False,
        opener=None, timings: dict | None = None) -> list[str]:
    """The reference's dem_zonal_stats.py: with ``generate_mosaic``,
    download the tiles the URL list names into ``initial_folder`` and
    mosaic them into ``{processed_folder}/DEM/DEM_aoi.tif``; unless
    ``skip_zonal_stats``, the classified roads' (``roads``, under
    ``final_folder``) elevation statistics into
    ``{processed_folder}/shapefiles_gpkg/roads_dem_zs.shp``. Returns the
    paths written; ``timings`` receives each stage's seconds."""
    import pandas as pd

    from ..io import read_file, write_file
    from ..utils.misc import ensure_dir_exists

    timings = {} if timings is None else timings
    written = []
    dem_dir = ensure_dir_exists(os.path.join(processed_folder, "DEM"))
    mosaic_path = os.path.join(dem_dir, "DEM_aoi.tif")

    if generate_mosaic:
        t0 = time.perf_counter()
        urls = pd.read_csv(os.path.join(initial_folder, url_file),
                           header=None)
        names = download_tiles(urls[0].unique().tolist(), initial_folder,
                               opener=opener)
        timings["download"] = time.perf_counter() - t0
        logger.info("Generating the mosaic from tiles...")
        t0 = time.perf_counter()
        written.append(make_mosaic(initial_folder, names, mosaic_path))
        timings["mosaic"] = time.perf_counter() - t0
        logger.info(f"DEM mosaic written: {mosaic_path}")

    if not skip_zonal_stats:
        logger.info("Calculating zonal stats...")
        t0 = time.perf_counter()
        zs = dem_zonal_stats(mosaic_path,
                             read_file(os.path.join(final_folder, roads)),
                             nodata=-9999)
        out = os.path.join(processed_folder, "shapefiles_gpkg",
                           "roads_dem_zs.shp")
        ensure_dir_exists(os.path.dirname(out))
        write_file(zs, out)
        written.append(out)
        timings["zonal_stats"] = time.perf_counter() - t0
        logger.info(f"Zonal stats written: {out}")
    return written


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="DEM mosaic + per-road elevation zonal statistics.")
    parser.add_argument("--initial-folder", default="data/DEM")
    parser.add_argument("--processed-folder", default="outputs")
    parser.add_argument("--final-folder", default="outputs/final")
    parser.add_argument("--url-file",
                        default="ch.swisstopo.swissalti3d_res2m.csv",
                        help="CSV of DEM tile URLs (one per line)")
    parser.add_argument("--roads",
                        default="shp_gpkg/types_from_detections.shp",
                        help="classified road polygons, relative to "
                             "--final-folder")
    parser.add_argument("--generate-mosaic", action="store_true")
    parser.add_argument("--skip-zonal-stats", action="store_true")
    args = parser.parse_args(argv)
    run(args.initial_folder, args.processed_folder, args.final_folder,
        args.url_file, args.roads, args.generate_mosaic,
        args.skip_zonal_stats)
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
