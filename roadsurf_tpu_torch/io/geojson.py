"""GeoJSON reader and writer (a copy of the reference package's
``io/geojson.py``).

The pipeline exchanges tiles_aoi.geojson, ground_truth_labels.geojson,
other_labels.geojson and split_aoi_tiles.geojson through this format; a
CRS other than EPSG:4326 is written as an ``urn:ogc:def:crs:EPSG::`` name."""

from __future__ import annotations

import json
import math

import numpy as np
import pandas as pd

from ..crs import CRS
from ..geom.core import mapping
from ..geom.table import GeoDataFrame


def read_geojson(path: str) -> GeoDataFrame:
    with open(path) as f:
        obj = json.load(f)
    if obj.get("type") == "FeatureCollection":
        feats = obj.get("features", [])
    elif obj.get("type") == "Feature":
        feats = [obj]
    else:  # bare geometry
        feats = [{"type": "Feature", "properties": {}, "geometry": obj}]
    crs = CRS(4326)
    cobj = obj.get("crs")
    if cobj:
        name = str(cobj.get("properties", {}).get("name", ""))
        for code in (2056, 3857, 4326):
            if str(code) in name:
                crs = CRS(code)
                break
    gdf = GeoDataFrame.from_features(feats, crs=crs)
    return gdf


def _json_safe(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        v = float(v)
    if isinstance(v, float) and math.isnan(v):
        return None
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if pd.isna(v):
        return None
    if isinstance(v, (str, int, float, bool, list, dict)):
        return v
    return str(v)


def write_geojson(gdf: GeoDataFrame, path: str) -> None:
    cols = [c for c in gdf.columns if c != "geometry"]
    feats = []
    for i in range(len(gdf)):
        row = gdf.iloc[i]
        g = row["geometry"]
        props = {c: _json_safe(row[c]) for c in cols}
        feats.append({
            "type": "Feature",
            "properties": props,
            "geometry": mapping(g) if g is not None else None,
        })
    fc: dict = {"type": "FeatureCollection", "features": feats}
    if gdf.crs is not None and CRS(gdf.crs).epsg != 4326:
        fc["crs"] = {"type": "name", "properties": {
            "name": f"urn:ogc:def:crs:EPSG::{CRS(gdf.crs).epsg}"}}
    with open(path, "w") as f:
        json.dump(fc, f)
