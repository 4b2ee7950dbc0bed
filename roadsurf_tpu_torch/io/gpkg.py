"""GeoPackage writer on the stdlib sqlite3, for the detections table.

The reference's ``io/gpkg.py`` ``write_gpkg`` with the same schema and rows:
the SRS rows, ``gpkg_contents`` (bounds, ``last_change``, srs),
``gpkg_geometry_columns``, then one feature table whose rows hold a
GeoPackage binary blob (GPB header with the envelope + WKB) and the
attribute columns. The pipeline's later stages read
``{ds}_detections_at_0dot05_threshold.gpkg`` with ``score`` and
``det_class``.
"""

from __future__ import annotations

import math
import os
import sqlite3
import struct

import numpy as np

from ..geom.table import DetectionTable
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


def _sql_type(col: np.ndarray) -> str:
    if col.dtype.kind in "iu":
        return "INTEGER"
    if col.dtype.kind == "f":
        return "REAL"
    return "TEXT"


def _sql_value(v):
    if isinstance(v, np.integer):
        return int(v)
    return None if math.isnan(v) else float(v)


def write_gpkg(table: DetectionTable, path: str,
               layer: str | None = None) -> None:
    layer = layer or os.path.splitext(os.path.basename(path))[0]
    srs_id = table.epsg
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

        cols = [c for c in table.columns if c != "geometry"]
        data = [getattr(table, c) for c in cols]
        defs = [f'"{c}" {_sql_type(d)}' for c, d in zip(cols, data)]
        cur.execute(
            f'CREATE TABLE "{layer}" (fid INTEGER PRIMARY KEY '
            f'AUTOINCREMENT, geom BLOB{", " if defs else ""}'
            f'{", ".join(defs)})')

        geoms = table.geometry
        tb = table.total_bounds if len(table) else (0, 0, 0, 0)
        gtypes = {g.geom_type.upper() for g in geoms if g is not None}
        gtype = gtypes.pop() if len(gtypes) == 1 else "GEOMETRY"

        rows = []
        for i, g in enumerate(geoms):
            blob = (_gpb_header(srs_id, g.bounds) + wkb.dumps(g)
                    if g is not None and not g.is_empty else None)
            rows.append([blob] + [_sql_value(d[i]) for d in data])
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
