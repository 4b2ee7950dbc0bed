"""Masked pixel extraction and zonal statistics over tile imagery (a copy
of the reference package's ``stats/pixels.py``, the upstream
fct_misc.get_pixel_values and its rasterstats zonal_stats path). A
geometry's mask is the even-odd pixel-centre fill of ``csrc/geomcore.cpp``
(``geom_rasterize``); the tiles are read by ``io/geotiff.py``."""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..geom import _native as N
from ..geom.core import BaseGeometry
from ..io.geotiff import Raster, read_geotiff


def _geometry_mask(geom: BaseGeometry, raster: Raster) -> np.ndarray:
    """Rasterize ``geom`` (in the raster's CRS) onto the raster's grid."""
    h, w = raster.data.shape[:2]
    x0, y0 = raster.origin
    sx, sy = raster.pixel_size
    flat = geom._flat()
    # pixel (r, c) has its centre at (x0 + (c + .5)·dx, y0 + (r + .5)·dy):
    # a north-up raster passes dy = -sy from its top edge
    return N.rasterize(flat, x0, sx, y0, -sy, h, w)


def get_pixel_values(geometry: BaseGeometry, tile_path: str, bands,
                     pixel_values: pd.DataFrame | None = None,
                     **kwargs) -> pd.DataFrame:
    """The values of the pixels under ``geometry`` in one tile, one column
    ``band{i}`` a requested band, appended to ``pixel_values``. Ragged bands
    are padded with the nodata value, pixels equal to nodata in every band
    (0 where the tile has none) dropped; ``kwargs`` become constant columns
    (e.g. road_id)."""
    if pixel_values is None:
        pixel_values = pd.DataFrame()
    r = read_geotiff(tile_path)
    mask = _geometry_mask(geometry, r).astype(bool)
    if not mask.any():
        return pixel_values

    nodata = r.nodata
    cols: dict[str, np.ndarray] = {}
    for b in bands:
        vals = r.data[:, :, b - 1][mask].astype(np.float64)
        cols[f"band{b}"] = vals
    n = max(len(v) for v in cols.values())
    pad_value = nodata if nodata is not None else 0.0
    for k, v in cols.items():
        if len(v) < n:
            cols[k] = np.concatenate([v, np.full(n - len(v), pad_value)])

    df = pd.DataFrame(cols)
    if nodata is not None:
        keep = ~np.all(df.values == nodata, axis=1)
        df = df[keep]
    else:
        keep = ~np.all(df.values == 0, axis=1)
        df = df[keep]
    for k, v in kwargs.items():
        df[k] = v
    return pd.concat([pixel_values, df], ignore_index=True)


def zonal_stats(geometry: BaseGeometry, tile_path: str, stats=None,
                band: int = 1, nodata: float | None = 0.0) -> list[dict]:
    """rasterstats' zonal_stats for one geometry and one band of a tile."""
    stats = stats or ["min", "max", "mean", "median", "std", "count"]
    r = read_geotiff(tile_path)
    mask = _geometry_mask(geometry, r).astype(bool)
    vals = r.data[:, :, band - 1][mask].astype(np.float64)
    if nodata is not None:
        vals = vals[vals != nodata]
    out = {}
    for s in stats:
        if not len(vals):
            out[s] = None if s != "count" else 0
            continue
        if s == "count":
            out[s] = int(len(vals))
        elif s == "median":
            out[s] = float(np.median(vals))
        else:
            out[s] = float(getattr(np, s)(vals))
    return [out]
