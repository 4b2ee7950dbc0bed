"""The port's vector and table I/O (``roadsurf_tpu_torch/io``: shapefile,
GeoJSON, xlsx, GeoPackage, the ``read_file``/``write_file`` dispatch)
against the reference package's.

* From the same table, each package writes a shapefile (.shp, .shx, .dbf,
  .prj, .cpg), a GeoJSON and an xlsx that are equal byte for byte, and a
  GeoPackage whose rows and metadata are equal (its ``last_change`` is a
  clock reading).
* Each package reads the other's files into equal tables.

Both writers stamp the day (the .dbf header) and the time (the xlsx zip
entries); the tests hold the clock still for both.
"""

from __future__ import annotations

import datetime
import sqlite3
import time
import types

import numpy as np
import pandas as pd
import pytest
import torch

import test_torch_geom as tg
from roadsurf_tpu import io as jio
from roadsurf_tpu.geom import core as jcore
from roadsurf_tpu.geom import table as jtable
from roadsurf_tpu.io import shapefile as jshp
from roadsurf_tpu_torch import io as tio
from roadsurf_tpu_torch.geom import core as tcore
from roadsurf_tpu_torch.geom import table as ttable
from roadsurf_tpu_torch.io import shapefile as tshp

torch.set_num_threads(1)

EXTS = ("shp", "geojson", "gpkg")


def _tables(kind: str):
    """The same table in each package: polygons with holes, a multipolygon,
    lines or points, with int, float (a NaN among them), str and bool
    columns, in EPSG:2056."""
    out = []
    for core, table in ((jcore, jtable), (tcore, ttable)):
        geoms = []
        for i in range(6):
            o = np.array([2600000.0, 1200000.0]) + 100 * i
            if kind == "polygon":
                shell = o + np.array(
                    [[0, 0], [40, 0], [40, 30], [20, 45], [0, 30], [0, 10]])
                hole = o + np.array([[10, 10], [20, 10], [20, 20], [10, 20]])
                g = core.Polygon(shell, [hole] if i % 2 else [])
                if i == 5:
                    g = core.MultiPolygon([g, core.Polygon(shell + 60)])
            elif kind == "line":
                g = core.LineString(o + np.cumsum(
                    np.full((4, 2), [12.5, 7.25]), 0))
            else:
                g = core.Point(*(o + [1.5, 2.25]))
            geoms.append(g)
        out.append(table.GeoDataFrame({
            "OBJECTID": np.arange(1, 7), "OBJEKTART": [2, 9, 9, 2, 20, 21],
            "road_len": [1.5, np.nan, 3.25, 4.0, 5.125, 6.0],
            "CATEGORY": ["artificial", "natural", "else", "artificial",
                         "natural", "ä ö"],
            "flag": [True, False, True, True, False, True],
            "geometry": geoms}, crs="EPSG:2056"))
    return out


@pytest.fixture
def still_clock(monkeypatch):
    """The .dbf date and the xlsx entries' times, held for both writers."""
    day = types.SimpleNamespace(date=types.SimpleNamespace(
        today=lambda: datetime.date(2026, 1, 2)))
    monkeypatch.setattr(jshp, "_dt", day)
    monkeypatch.setattr(tshp, "_dt", day)
    now = time.mktime((2026, 1, 2, 3, 4, 6, 0, 0, -1))
    monkeypatch.setattr(time, "time", lambda: now)


def _gpkg_rows(path):
    con = sqlite3.connect(path)
    try:
        out = {}
        for t in ("gpkg_spatial_ref_sys", "gpkg_geometry_columns"):
            out[t] = con.execute(f"SELECT * FROM {t}").fetchall()
        out["contents"] = con.execute(
            "SELECT table_name, data_type, identifier, min_x, min_y, max_x, "
            "max_y, srs_id FROM gpkg_contents").fetchall()
        layer = out["contents"][0][0]
        out["schema"] = con.execute(
            f'PRAGMA table_info("{layer}")').fetchall()
        out["rows"] = con.execute(f'SELECT * FROM "{layer}"').fetchall()
        return out
    finally:
        con.close()


@pytest.mark.parametrize("kind", ["polygon", "line", "point"])
@pytest.mark.parametrize("ext", EXTS)
def test_written_files_equal_the_reference(tmp_path, still_clock, ext, kind):
    ref, port = _tables(kind)
    for who in ("ref", "port"):
        (tmp_path / who).mkdir()
    # the same file name: the GeoPackage layer is named after it
    jio.write_file(ref, str(tmp_path / "ref" / f"t.{ext}"))
    tio.write_file(port, str(tmp_path / "port" / f"t.{ext}"))
    if ext == "gpkg":
        assert _gpkg_rows(tmp_path / "port" / "t.gpkg") == \
            _gpkg_rows(tmp_path / "ref" / "t.gpkg")
        return
    sides = (".shp", ".shx", ".dbf", ".prj", ".cpg") if ext == "shp" \
        else (f".{ext}",)
    for side in sides:
        assert (tmp_path / "port" / f"t{side}").read_bytes() == \
            (tmp_path / "ref" / f"t{side}").read_bytes(), side


@pytest.mark.parametrize("kind", ["polygon", "line", "point"])
@pytest.mark.parametrize("ext", EXTS)
def test_each_reads_the_others_files(tmp_path, ext, kind):
    ref, port = _tables(kind)
    jio.write_file(ref, str(tmp_path / f"ref.{ext}"))
    tio.write_file(port, str(tmp_path / f"port.{ext}"))
    tg.assert_tables_equal(tio.read_file(str(tmp_path / f"ref.{ext}")),
                           jio.read_file(str(tmp_path / f"ref.{ext}")))
    tg.assert_tables_equal(tio.read_file(str(tmp_path / f"port.{ext}")),
                           jio.read_file(str(tmp_path / f"port.{ext}")))


def test_xlsx_equals_the_reference(tmp_path, still_clock):
    df = pd.DataFrame({
        "GDB-Code": [2, 9, 20, 21, 14], "Type": ["Strasse", "Weg", "a&b",
                                                 "<c>", "Faehre"],
        "to keep": ["yes", "yes", "yes", "yes", "no"],
        "Width": [8.0, 4.0, 5.5, 6.0, None]})
    jio.xlsx.write_xlsx(df, str(tmp_path / "ref.xlsx"))
    tio.write_xlsx(df, str(tmp_path / "port.xlsx"))
    assert (tmp_path / "port.xlsx").read_bytes() == \
        (tmp_path / "ref.xlsx").read_bytes()
    for path in ("ref.xlsx", "port.xlsx"):
        got = tio.read_excel(str(tmp_path / path))
        pd.testing.assert_frame_equal(
            got, jio.read_excel(str(tmp_path / path)))
        assert list(got["GDB-Code"]) == [2, 9, 20, 21, 14]
        assert np.isnan(got["Width"].iloc[4])


def test_detection_table_and_frame_write_the_same_gpkg(tmp_path):
    """The port's writer takes the detection host stage's table (a
    GeoDataFrame of numpy float64 scores and int64 classes, as
    ``pipeline/detections.py::detect_dataset`` builds it) and a frame of
    Python lists; the same polygons and columns give the same rows."""
    polys = [tcore.Polygon([[0, 0], [2, 0], [2, 2], [0, 2]]),
             tcore.Polygon([[5, 5], [6, 5], [6, 6], [5, 6]])]
    det = ttable.GeoDataFrame({"geometry": polys,
                               "score": np.array([0.5, 0.75], np.float64),
                               "det_class": np.array([0, 1], np.int64)},
                              crs="EPSG:4326")
    frame = ttable.GeoDataFrame({"score": [0.5, 0.75], "det_class": [0, 1],
                                 "geometry": polys}, crs=4326)
    tio.write_gpkg(det, str(tmp_path / "det.gpkg"), layer="x")
    tio.write_gpkg(frame, str(tmp_path / "frame.gpkg"), layer="x")
    assert _gpkg_rows(tmp_path / "det.gpkg") == \
        _gpkg_rows(tmp_path / "frame.gpkg")
    back = tio.read_gpkg(str(tmp_path / "det.gpkg"))
    assert list(back["det_class"]) == [0, 1]
    assert [tg.geom_key(g) for g in back.geometry.values] == \
        [tg.geom_key(g) for g in polys]
