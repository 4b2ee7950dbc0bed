"""ESRI Shapefile reader and writer (a copy of the reference package's
``io/shapefile.py``).

Supports the shape types the pipeline touches: Point (1), PolyLine (3),
Polygon (5) with their Z/M variants read as 2-d, plus the companion .dbf
attribute table, .shx index, .prj and .cpg sidecars. Label preparation
reads the swissTLM3D roads and forests and the AOI, and writes
roads_for_OD.shp. The .dbf header carries the day it was written.
"""

from __future__ import annotations

import datetime as _dt
import os
import struct

import numpy as np
import pandas as pd

from ..crs import CRS
from ..geom.core import (LineString, MultiLineString, MultiPolygon, Point,
                         Polygon, _close_ring, _ring_area)
from ..geom.table import GeoDataFrame

SHP_NULL, SHP_POINT, SHP_POLYLINE, SHP_POLYGON = 0, 1, 3, 5
_Z = {11: SHP_POINT, 13: SHP_POLYLINE, 15: SHP_POLYGON,
      21: SHP_POINT, 23: SHP_POLYLINE, 25: SHP_POLYGON}

_WKT = {
    2056: ('PROJCS["CH1903+ / LV95",GEOGCS["CH1903+",DATUM["CH1903+",'
           'SPHEROID["Bessel 1841",6377397.155,299.1528128]],'
           'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]],'
           'PROJECTION["Hotine_Oblique_Mercator_Azimuth_Center"],'
           'PARAMETER["latitude_of_center",46.9524055555556],'
           'PARAMETER["longitude_of_center",7.43958333333333],'
           'PARAMETER["azimuth",90],PARAMETER["rectified_grid_angle",90],'
           'PARAMETER["scale_factor",1],PARAMETER["false_easting",2600000],'
           'PARAMETER["false_northing",1200000],UNIT["metre",1],'
           'AUTHORITY["EPSG","2056"]]'),
    4326: ('GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
           '298.257223563]],PRIMEM["Greenwich",0],'
           'UNIT["degree",0.0174532925199433],AUTHORITY["EPSG","4326"]]'),
    3857: ('PROJCS["WGS 84 / Pseudo-Mercator",GEOGCS["WGS 84",'
           'DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563]],'
           'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]],'
           'PROJECTION["Mercator_1SP"],PARAMETER["central_meridian",0],'
           'PARAMETER["scale_factor",1],PARAMETER["false_easting",0],'
           'PARAMETER["false_northing",0],UNIT["metre",1],'
           'AUTHORITY["EPSG","3857"]]'),
}


def _crs_from_prj(path: str):
    if not os.path.exists(path):
        return None
    wkt = open(path, encoding="utf-8", errors="replace").read()
    for code in (2056, 4326, 3857):
        if f'"EPSG","{code}"' in wkt or f'"{code}"' in wkt.split("AUTHORITY")[-1]:
            return CRS(code)
    if "CH1903+" in wkt or "LV95" in wkt:
        return CRS(2056)
    if "Pseudo-Mercator" in wkt or "3857" in wkt:
        return CRS(3857)
    if "WGS 84" in wkt or "WGS_1984" in wkt:
        return CRS(4326)
    return None


# ---------------------------------------------------------------------------
# reading

def read_shapefile(path: str) -> GeoDataFrame:
    base, _ = os.path.splitext(path)
    geoms = _read_shp(base + ".shp")
    table = _read_dbf(base + ".dbf") if os.path.exists(base + ".dbf") else \
        pd.DataFrame(index=range(len(geoms)))
    crs = _crs_from_prj(base + ".prj")
    gdf = GeoDataFrame(table)
    gdf["geometry"] = geoms
    gdf.crs = crs
    return gdf


def _read_shp(path: str):
    data = open(path, "rb").read()
    geoms = []
    pos = 100  # skip header
    n = len(data)
    while pos + 8 <= n:
        (_, clen) = struct.unpack(">ii", data[pos:pos + 8])
        pos += 8
        rec = data[pos:pos + 2 * clen]
        pos += 2 * clen
        if len(rec) < 4:
            break
        stype = struct.unpack("<i", rec[:4])[0]
        stype = _Z.get(stype, stype)
        if stype == SHP_NULL:
            geoms.append(None)
        elif stype == SHP_POINT:
            x, y = struct.unpack("<2d", rec[4:20])
            geoms.append(Point(x, y))
        elif stype in (SHP_POLYLINE, SHP_POLYGON):
            nparts, npoints = struct.unpack("<2i", rec[36:44])
            parts = struct.unpack(f"<{nparts}i", rec[44:44 + 4 * nparts])
            off = 44 + 4 * nparts
            pts = np.frombuffer(rec, dtype="<f8", count=2 * npoints,
                                offset=off).reshape(-1, 2)
            rings = []
            for k in range(nparts):
                lo = parts[k]
                hi = parts[k + 1] if k + 1 < nparts else npoints
                rings.append(pts[lo:hi].copy())
            if stype == SHP_POLYLINE:
                geoms.append(rings[0] if len(rings) == 1 else rings)
                geoms[-1] = (LineString(rings[0]) if len(rings) == 1
                             else MultiLineString(rings))
            else:
                geoms.append(_assemble_polygon(rings))
        else:
            raise ValueError(f"unsupported shape type {stype}")
    return geoms


def _assemble_polygon(rings):
    """Shapefile rings: shells CW (negative shoelace), holes CCW."""
    shells, holes = [], []
    for r in rings:
        rr = r[:-1] if len(r) > 1 and np.array_equal(r[0], r[-1]) else r
        if len(rr) < 3:
            continue
        if _ring_area(rr) < 0:
            shells.append(rr)
        else:
            holes.append(rr)
    if not shells:
        if not holes:
            return None
        shells, holes = holes, []  # tolerate mis-oriented writers
    polys = [[s, []] for s in shells]
    for h in holes:
        pt = h.mean(axis=0)
        target = None
        for entry in polys:
            s = entry[0]
            if (s[:, 0].min() <= pt[0] <= s[:, 0].max()
                    and s[:, 1].min() <= pt[1] <= s[:, 1].max()):
                poly = Polygon(s)
                if poly.contains(Point(*pt)):
                    target = entry
                    break
        (target or polys[0])[1].append(h)
    ps = [Polygon(s, hs) for s, hs in polys]
    return ps[0] if len(ps) == 1 else MultiPolygon(ps)


def _read_dbf(path: str) -> pd.DataFrame:
    data = open(path, "rb").read()
    nrec, hsize, rsize = struct.unpack("<IHH", data[4:12])
    fields = []
    pos = 32
    while pos < hsize - 1 and data[pos] != 0x0D:
        fd = data[pos:pos + 32]
        name = fd[:11].split(b"\x00")[0].decode("ascii", "replace")
        ftype = chr(fd[11])
        flen = fd[16]
        fdec = fd[17]
        fields.append((name, ftype, flen, fdec))
        pos += 32
    cols: dict[str, list] = {f[0]: [] for f in fields}
    pos = hsize
    for _ in range(nrec):
        rec = data[pos:pos + rsize]
        pos += rsize
        if not rec or rec[0:1] == b"*":  # deleted
            continue
        off = 1
        for name, ftype, flen, fdec in fields:
            raw = rec[off:off + flen]
            off += flen
            cols[name].append(_parse_dbf_value(raw, ftype, fdec))
    return pd.DataFrame(cols)


def _parse_dbf_value(raw: bytes, ftype: str, fdec: int):
    if ftype in ("N", "F"):
        s = raw.strip()
        if not s or s in (b"*" * len(s),):
            return np.nan
        try:
            return float(s) if (fdec > 0 or b"." in s or b"e" in s.lower()) \
                else int(s)
        except ValueError:
            return np.nan
    if ftype == "L":
        return raw in b"YyTt"
    if ftype == "D":
        s = raw.strip().decode("ascii", "replace")
        return s or None
    return raw.decode("utf-8", "replace").strip()


# ---------------------------------------------------------------------------
# writing

def write_shapefile(gdf: GeoDataFrame, path: str) -> None:
    base, _ = os.path.splitext(path)
    geoms = list(gdf["geometry"].values)
    stype = _pick_shape_type(geoms)
    recs = [_encode_shape(g, stype) for g in geoms]
    _write_shp_shx(base, stype, geoms, recs)
    _write_dbf(base + ".dbf",
               gdf.drop(columns=["geometry"], errors="ignore"))
    if gdf.crs is not None and CRS(gdf.crs).epsg in _WKT:
        with open(base + ".prj", "w") as f:
            f.write(_WKT[CRS(gdf.crs).epsg])
    with open(base + ".cpg", "w") as f:
        f.write("UTF-8")


def _pick_shape_type(geoms) -> int:
    for g in geoms:
        if g is None:
            continue
        t = g.geom_type
        if t in ("Polygon", "MultiPolygon"):
            return SHP_POLYGON
        if t in ("LineString", "MultiLineString"):
            return SHP_POLYLINE
        if t == "Point":
            return SHP_POINT
    return SHP_NULL


def _shape_rings(g, stype):
    if stype == SHP_POLYGON:
        polys = g.geoms if g.geom_type == "MultiPolygon" else [g]
        rings = []
        for p in polys:
            ext = _close_ring(p.exterior_coords)
            if _ring_area(p.exterior_coords) > 0:
                ext = ext[::-1]  # shells CW
            rings.append(ext)
            for h in p.interiors_coords:
                hc = _close_ring(h)
                if _ring_area(h) < 0:
                    hc = hc[::-1]  # holes CCW
                rings.append(hc)
        return rings
    lines = g.geoms if g.geom_type == "MultiLineString" else [g]
    return [l.coords_array for l in lines]


def _encode_shape(g, stype) -> bytes:
    if g is None or (stype != SHP_POINT and g.is_empty):
        return struct.pack("<i", SHP_NULL)
    if stype == SHP_POINT:
        return struct.pack("<i2d", SHP_POINT, g.x, g.y)
    rings = _shape_rings(g, stype)
    pts = np.vstack(rings)
    parts = np.cumsum([0] + [len(r) for r in rings[:-1]]).astype("<i4")
    buf = struct.pack("<i4d", stype, pts[:, 0].min(), pts[:, 1].min(),
                      pts[:, 0].max(), pts[:, 1].max())
    buf += struct.pack("<2i", len(rings), len(pts))
    buf += parts.tobytes()
    buf += np.ascontiguousarray(pts, dtype="<f8").tobytes()
    return buf


def _write_shp_shx(base, stype, geoms, recs):
    valid = [g for g in geoms if g is not None and not getattr(g, "is_empty", False)]
    if valid:
        bs = np.array([g.bounds for g in valid])
        bbox = (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())
    else:
        bbox = (0.0, 0.0, 0.0, 0.0)

    content = b"".join(
        struct.pack(">2i", i + 1, len(r) // 2) + r
        for i, r in enumerate(recs))
    total_words = (100 + len(content)) // 2

    def header(length_words):
        return (struct.pack(">i5i", 9994, 0, 0, 0, 0, 0)
                + struct.pack(">i", length_words)
                + struct.pack("<2i", 1000, stype)
                + struct.pack("<4d", *bbox) + struct.pack("<4d", 0, 0, 0, 0))

    with open(base + ".shp", "wb") as f:
        f.write(header(total_words))
        f.write(content)

    with open(base + ".shx", "wb") as f:
        f.write(header((100 + 8 * len(recs)) // 2))
        off = 50
        for r in recs:
            f.write(struct.pack(">2i", off, len(r) // 2))
            off += 4 + len(r) // 2


def _write_dbf(path: str, df: pd.DataFrame) -> None:
    fields = []
    encoded: list[list[bytes]] = []
    for col in df.columns:
        s = df[col]
        name = str(col)[:10].encode("ascii", "replace")
        if pd.api.types.is_integer_dtype(s):
            # size the field to the widest value so nothing truncates
            strs = [str(int(v)) for v in s]
            flen = min(max([len(x) for x in strs] + [1]), 254)
            fdec, ftype = 0, b"N"
            vals = [x.rjust(flen).encode() for x in strs]
        elif pd.api.types.is_float_dtype(s):
            fdec, ftype = 10, b"N"
            strs = ["" if pd.isna(v) else f"{v:.10f}" for v in s]
            flen = min(max([len(x) for x in strs] + [12]), 254)
            vals = [(" " * flen).encode() if not x
                    else x.rjust(flen).encode() for x in strs]
        elif pd.api.types.is_bool_dtype(s):
            flen, fdec, ftype = 1, 0, b"L"
            vals = [(b"T" if v else b"F") for v in s]
        else:
            svals = ["" if pd.isna(v) else str(v) for v in s]
            flen = min(max([len(x.encode("utf-8")) for x in svals] + [1]), 254)
            fdec, ftype = 0, b"C"
            vals = [x.encode("utf-8")[:flen].ljust(flen) for x in svals]
        fields.append((name, ftype, flen, fdec))
        encoded.append(vals)

    nrec = len(df)
    rsize = 1 + sum(f[2] for f in fields)
    hsize = 32 + 32 * len(fields) + 1
    now = _dt.date.today()
    with open(path, "wb") as f:
        f.write(struct.pack("<4B", 0x03, now.year - 1900, now.month, now.day))
        f.write(struct.pack("<IHH", nrec, hsize, rsize))
        f.write(b"\x00" * 20)
        for name, ftype, flen, fdec in fields:
            f.write(name.ljust(11, b"\x00") + ftype + b"\x00" * 4
                    + struct.pack("<BB", flen, fdec) + b"\x00" * 14)
        f.write(b"\x0d")
        for i in range(nrec):
            f.write(b" ")
            for vals in encoded:
                f.write(vals[i])
        f.write(b"\x1a")
