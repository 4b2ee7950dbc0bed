"""GeoPackage reader and writer on the stdlib sqlite3.

The reference package's ``io/gpkg.py`` with the same schema and rows: the
SRS rows, ``gpkg_contents`` (bounds, ``last_change``, srs),
``gpkg_geometry_columns``, then one feature table whose rows hold a
GeoPackage binary blob (GPB header with the envelope + WKB) and the
attribute columns. ``write_gpkg`` takes a ``GeoDataFrame`` (columns typed
from their pandas dtypes, values as the reference converts them); the
pipeline's later stages read ``{ds}_detections_at_0dot05_threshold.gpkg``
back with ``read_gpkg``.
"""

from __future__ import annotations

import os
import sqlite3
import struct

import numpy as np
import pandas as pd

from ..crs import CRS
from ..geom.table import GeoDataFrame
from . import wkb

_SRS_ROWS = [
    ("Undefined cartesian SRS", -1, "NONE", -1, "undefined", None),
    ("Undefined geographic SRS", 0, "NONE", 0, "undefined", None),
    ("WGS 84 geodetic", 4326, "EPSG", 4326,
     'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
     '298.257223563]],PRIMEM["Greenwich",0],'
     'UNIT["degree",0.0174532925199433],AUTHORITY["EPSG","4326"]]', None),
    ("CH1903+ / LV95", 2056, "EPSG", 2056, "PROJCS[CH1903+ / LV95]", None),
    ("WGS 84 / Pseudo-Mercator", 3857, "EPSG", 3857,
     "PROJCS[WGS 84 / Pseudo-Mercator]", None),
]


def _gpb_header(srs_id: int, bounds) -> bytes:
    # flags: little-endian byte order (bit0), envelope indicator 1 (32..)
    flags = 0b00000011  # envelope [minx,maxx,miny,maxy] + LE
    return (b"GP" + struct.pack("<BBi", 0, flags, srs_id)
            + struct.pack("<4d", bounds[0], bounds[2], bounds[1], bounds[3]))


def _parse_gpb(blob: bytes):
    if blob is None or len(blob) < 8 or blob[:2] != b"GP":
        return None
    flags = blob[3]
    env = (flags >> 1) & 0b111
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}[env]
    return wkb.loads(blob[8 + env_len:])


def _frame_type(s: pd.Series) -> str:
    if pd.api.types.is_integer_dtype(s):
        return "INTEGER"
    if pd.api.types.is_float_dtype(s):
        return "REAL"
    return "TEXT"


def _frame_value(v):
    if pd.isna(v):
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (int, float, str)):
        return v
    return str(v)


def _columns(table: GeoDataFrame):
    """(names, SQL types, per-row values, geometries, srs id) of a
    ``GeoDataFrame``."""
    cols = [c for c in table.columns if c != "geometry"]
    rows = [[_frame_value(table.iloc[i][c]) for c in cols]
            for i in range(len(table))]
    srs_id = CRS(table.crs).epsg if table.crs is not None else 0
    return (cols, [_frame_type(table[c]) for c in cols], rows,
            list(table["geometry"].values), srs_id)


def write_gpkg(table: GeoDataFrame, path: str,
               layer: str | None = None) -> None:
    layer = layer or os.path.splitext(os.path.basename(path))[0]
    cols, types, values, geoms, srs_id = _columns(table)
    if os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        cur.execute("PRAGMA application_id = 1196444487")  # 'GPKG'
        cur.execute("PRAGMA user_version = 10300")
        cur.execute(
            "CREATE TABLE gpkg_spatial_ref_sys (srs_name TEXT NOT NULL, "
            "srs_id INTEGER PRIMARY KEY, organization TEXT NOT NULL, "
            "organization_coordsys_id INTEGER NOT NULL, definition TEXT "
            "NOT NULL, description TEXT)")
        cur.executemany(
            "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
            _SRS_ROWS)
        cur.execute(
            "CREATE TABLE gpkg_contents (table_name TEXT PRIMARY KEY, "
            "data_type TEXT NOT NULL, identifier TEXT UNIQUE, description "
            "TEXT DEFAULT '', last_change DATETIME, min_x DOUBLE, min_y "
            "DOUBLE, max_x DOUBLE, max_y DOUBLE, srs_id INTEGER)")
        cur.execute(
            "CREATE TABLE gpkg_geometry_columns (table_name TEXT NOT NULL, "
            "column_name TEXT NOT NULL, geometry_type_name TEXT NOT NULL, "
            "srs_id INTEGER NOT NULL, z TINYINT NOT NULL, m TINYINT NOT "
            "NULL, CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, "
            "column_name))")

        defs = [f'"{c}" {t}' for c, t in zip(cols, types)]
        cur.execute(
            f'CREATE TABLE "{layer}" (fid INTEGER PRIMARY KEY '
            f'AUTOINCREMENT, geom BLOB{", " if defs else ""}'
            f'{", ".join(defs)})')

        tb = table.total_bounds if len(table) else (0, 0, 0, 0)
        gtypes = {g.geom_type.upper() for g in geoms if g is not None}
        gtype = gtypes.pop() if len(gtypes) == 1 else "GEOMETRY"

        rows = []
        for g, vals in zip(geoms, values):
            blob = (_gpb_header(srs_id, g.bounds) + wkb.dumps(g)
                    if g is not None and not g.is_empty else None)
            rows.append([blob] + vals)
        ph = ",".join(["?"] * (1 + len(cols)))
        colnames = ", ".join(["geom"] + [f'"{c}"' for c in cols])
        cur.executemany(
            f'INSERT INTO "{layer}" ({colnames}) VALUES ({ph})', rows)
        cur.execute(
            "INSERT INTO gpkg_contents (table_name, data_type, identifier, "
            "last_change, min_x, min_y, max_x, max_y, srs_id) VALUES "
            "(?, 'features', ?, datetime('now'), ?, ?, ?, ?, ?)",
            (layer, layer, float(tb[0]), float(tb[1]), float(tb[2]),
             float(tb[3]), srs_id))
        cur.execute(
            "INSERT INTO gpkg_geometry_columns VALUES (?, 'geom', ?, ?, 0, "
            "0)", (layer, gtype, srs_id))
        con.commit()
    finally:
        con.close()


def read_gpkg(path: str, layer: str | None = None) -> GeoDataFrame:
    """The feature layer ``layer`` (the first one when None) as a
    ``GeoDataFrame`` in its SRS (none when the port does not know it)."""
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        if layer is None:
            row = cur.execute(
                "SELECT table_name, srs_id FROM gpkg_geometry_columns "
                "LIMIT 1").fetchone()
            if row is None:
                raise ValueError(f"no feature layer in {path}")
            layer, srs_id = row
        else:
            row = cur.execute(
                "SELECT srs_id FROM gpkg_geometry_columns WHERE "
                "table_name=?", (layer,)).fetchone()
            srs_id = row[0] if row else 0
        gcol_row = cur.execute(
            "SELECT column_name FROM gpkg_geometry_columns WHERE "
            "table_name=?", (layer,)).fetchone()
        gcol = gcol_row[0] if gcol_row else "geom"
        info = cur.execute(f'PRAGMA table_info("{layer}")').fetchall()
        cols = [r[1] for r in info if r[1] not in (gcol, "fid")]
        sel = ", ".join([f'"{gcol}"'] + [f'"{c}"' for c in cols])
        data = cur.execute(f'SELECT {sel} FROM "{layer}"').fetchall()
    finally:
        con.close()
    geoms = [_parse_gpb(r[0]) for r in data]
    table = pd.DataFrame([r[1:] for r in data], columns=cols)
    gdf = GeoDataFrame(table)
    gdf["geometry"] = geoms
    try:
        gdf.crs = CRS(int(srs_id))
    except ValueError:
        gdf.crs = None
    return gdf
