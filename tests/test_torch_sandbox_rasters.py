"""The port's sandbox tools, raster utilities and upload
(``roadsurf_tpu_torch/pipeline/{sandbox,upload}.py``,
``roadsurf_tpu_torch/tiles/rasters.py``) against the reference package's,
on the CPU.

1. Every case of tests/test_sandbox_rasters.py runs through the port (the
   same source, its imports pointed at the port).
2. ``upload.run`` of each package on the same imagery into its own
   ``LocalStore`` (the YAML block's ``local_store_root``): the same keys
   with the same bytes, then a second run that uploads nothing.
3. The entry points that stand for the reference's scripts
   (limit_used_tiles.py, correct_gt.py, add_tile_mask.py,
   dem_zonal_stats.py, RS_images_to_S3.py) write what the reference's
   functions write on the same inputs, byte for byte.
"""

from __future__ import annotations

import filecmp
import os

import numpy as np
import pytest
import torch
import yaml

from roadsurf_tpu.pipeline import sandbox as jsandbox
from roadsurf_tpu.pipeline import upload as jupload
from roadsurf_tpu_torch.pipeline import sandbox as tsandbox
from roadsurf_tpu_torch.pipeline import upload as tupload
from roadsurf_tpu_torch.tiles import rasters as trasters
from test_torch_stats import run_reference_case

torch.set_num_threads(1)

FNAME = "test_sandbox_rasters.py"


def _cases():
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parent / FNAME).read_text()
    return re.findall(r"^def (test_\w+)\(", src, re.M)


def test_the_reference_cases_are_all_collected():
    assert len(_cases()) == 4


@pytest.mark.parametrize("name", _cases())
def test_reference_case_holds_in_the_port(name, tmp_path, monkeypatch):
    run_reference_case(FNAME, name, tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# 2. upload

def _imagery(root) -> str:
    """Seeded imagery files and a directory the glob also matches."""
    rng = np.random.default_rng(3)
    d = root / "images_RS"
    d.mkdir()
    for i in range(5):
        (d / f"img_{i}.tif").write_bytes(rng.bytes(1000 + 37 * i))
    (d / "subdir").mkdir()
    return str(d / "*")


def _store_files(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("outpath", ["data/images_RS/", ""])
def test_upload_writes_the_references_keys_and_resumes(outpath, tmp_path):
    datapath = _imagery(tmp_path)
    keys = {}
    for name, mod in (("ref", jupload), ("port", tupload)):
        cfg = {"datapath": datapath, "bucket": "proj-roadsurf",
               "outpath": outpath, "url": "https://s3.example.cloud",
               "local_store_root": str(tmp_path / f"store_{name}")}
        keys[name] = mod.run(cfg)
        assert mod.run(cfg) == []                  # all there: skipped
    assert keys["port"] == keys["ref"] and len(keys["port"]) == 5
    assert keys["port"][0] == f"{outpath.strip('/')}/img_0.tif".lstrip("/")
    got = _store_files(tmp_path / "store_port")
    assert got == _store_files(tmp_path / "store_ref")
    assert sorted(got) == sorted(keys["port"])


# ---------------------------------------------------------------------------
# 3. the entry points

def test_upload_entry_point_reads_its_yaml_block(tmp_path):
    datapath = _imagery(tmp_path)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({"RS_images_to_S3.py": {
        "datapath": datapath, "bucket": "b", "outpath": "rs",
        "local_store_root": str(tmp_path / "store")}}))
    assert tupload.main([str(path)]) == 0
    assert sorted(_store_files(tmp_path / "store")) == \
        [f"rs/img_{i}.tif" for i in range(5)]


def _rect(core, x0, y0, x1, y1):
    return core.Polygon([(x0, y0), (x1, y0), (x1, y1), (x0, y1)])


def test_sandbox_entry_points_write_the_references_files(tmp_path):
    from roadsurf_tpu.geom import core as jcore
    from roadsurf_tpu.geom.table import GeoDataFrame
    from roadsurf_tpu.io import write_file
    from roadsurf_tpu.io.geotiff import write_geotiff
    from roadsurf_tpu.tiles.grid import Tile, WebMercatorQuad

    # limit_used_tiles: its block of config_obj_detec.yaml, one workspace a
    # package (the block writes tiles_aoi.geojson over its input)
    with open(os.path.join(os.path.dirname(__file__), "..", "config",
                           "config_obj_detec.yaml")) as f:
        block = yaml.safe_load(f)["limit_used_tiles.py"]
    out = {}
    for pkg in ("ref", "port"):
        js = tmp_path / pkg / "json_inputs"
        js.mkdir(parents=True)
        write_file(GeoDataFrame(
            {"id": ["a", "b", "c"], "title": ["x"] * 3,
             "geometry": [_rect(jcore, 0, 0, 10, 10),
                          _rect(jcore, 20, 0, 30, 10),
                          _rect(jcore, 40, 0, 50, 10)]}, crs="EPSG:4326"),
            str(js / "tiles_aoi.geojson"), driver="GeoJSON")
        for name, r in (("ground_truth_labels", (2, 2, 4, 4)),
                        ("other_labels", (22, 2, 24, 4))):
            write_file(GeoDataFrame({"geometry": [_rect(jcore, *r)]},
                                    crs="EPSG:4326"),
                       str(js / f"{name}.geojson"), driver="GeoJSON")
        b = dict(block, working_directory=str(js))
        if pkg == "ref":
            jsandbox.run_limit_used_tiles(b)
        else:
            cfg = tmp_path / "obj.yaml"
            cfg.write_text(yaml.safe_dump({"limit_used_tiles.py": b}))
            assert tsandbox.main(["limit_used_tiles", str(cfg)]) == 0
        out[pkg] = (js / "tiles_aoi.geojson").read_bytes()
    assert out["port"] == out["ref"] and b'"c"' in out["port"] \
        and b'"b"' not in out["port"]

    # correct_gt: its block of config_preprocessing.yaml
    data = tmp_path / "data"
    (data / "swissTLM3D").mkdir(parents=True)
    roads = GeoDataFrame({"OBJECTID": [1, 2, 3], "BELAGSART": [100, 100, 200],
                          "geometry": [_rect(jcore, 0, 0, 1, 1)] * 3},
                         crs="EPSG:2056")
    corr = GeoDataFrame({"OBJECTID": [2, 3], "Belag_veri": [200, 12345],
                         "geometry": [_rect(jcore, 0, 0, 1, 1)] * 2},
                        crs="EPSG:2056")
    write_file(roads, str(data / "swissTLM3D" / "roads_lines.shp"))
    write_file(corr, str(data / "swissTLM3D" / "feedback.shp"))
    block = {"input": {"input_folder": str(data), "input_files": {
        "initial_roads": "swissTLM3D/roads_lines.shp",
        "corrections": "swissTLM3D/feedback.shp"}}}
    write_file(jsandbox.correct_gt(roads, corr), str(data / "ref.shp"))
    cfg = tmp_path / "pre.yaml"
    cfg.write_text(yaml.safe_dump({"correct_gt.py": block}))
    assert tsandbox.main(["correct_gt", str(cfg)]) == 0
    for ext in (".shp", ".dbf", ".shx"):
        assert filecmp.cmp(data / f"ref{ext}",
                           data / f"corrected_roads_inside_AOI{ext}",
                           shallow=False), ext

    # add_tile_mask: a road across a tile, both in EPSG:3857 files
    t = Tile(137150, 92343, 18)
    w, s, e, n = WebMercatorQuad.xy_bounds(t)
    for pkg in ("ref", "port"):
        (tmp_path / pkg / "trn-images").mkdir(parents=True)
        write_geotiff(str(tmp_path / pkg / "trn-images"
                          / WebMercatorQuad.tile_filename(t)),
                      np.full((256, 256, 3), 50, np.uint8), (w, s, e, n))
    road = GeoDataFrame({"geometry": [_rect(jcore, w, (s + n) / 2 - 20, e,
                                            (s + n) / 2 + 20)]},
                        crs="EPSG:3857")
    tile = GeoDataFrame({"id": [WebMercatorQuad.formatted_id(t)],
                         "dataset": ["trn"],
                         "geometry": [_rect(jcore, w, s, e, n)]},
                        crs="EPSG:3857")
    write_file(road, str(tmp_path / "road.shp"))
    write_file(tile.to_crs(epsg=4326), str(tmp_path / "tiles.geojson"),
               driver="GeoJSON")
    jsandbox.add_tile_mask(road, tile, str(tmp_path / "ref"))
    assert tsandbox.main(["add_tile_mask", "--roads",
                          str(tmp_path / "road.shp"), "--tiles",
                          str(tmp_path / "tiles.geojson"), "--images-root",
                          str(tmp_path / "port")]) == 0
    name = WebMercatorQuad.tile_filename(t)
    from roadsurf_tpu_torch.io import read_geotiff

    got = read_geotiff(str(tmp_path / "port" / "trn-images" / name))
    want = read_geotiff(str(tmp_path / "ref" / "trn-images" / name))
    assert got.data.shape == (256, 256, 4)
    np.testing.assert_array_equal(got.data, want.data)


def test_dem_entry_point_writes_the_references_files(tmp_path):
    """dem_zonal_stats.py's flow: a URL list, the tiles through the
    opener, the mosaic and the roads' elevation statistics."""
    from roadsurf_tpu.geom import core as jcore
    from roadsurf_tpu.geom.table import GeoDataFrame
    from roadsurf_tpu.io import write_file
    from roadsurf_tpu.io.geotiff import write_geotiff
    from roadsurf_tpu.tiles import rasters as jrasters

    rng = np.random.default_rng(8)
    served = {}
    for i in range(2):
        for j in range(2):
            # whole metres in uint16 (the GeoTIFF codec of both packages
            # takes 8- and 16-bit unsigned samples), a nodata corner
            d = (400 + rng.normal(0, 5, (50, 50, 1))).round() \
                .astype(np.uint16)
            d[:3, :3] = 0
            p = str(tmp_path / f"src_{i}{j}.tif")
            x0, y0 = 2600000 + 100 * i, 1200000 + 100 * j
            write_geotiff(p, d, (x0, y0, x0 + 100, y0 + 100), epsg=2056,
                          nodata=0.0)
            with open(p, "rb") as f:
                served[f"http://dem/t_{i}{j}.tif"] = f.read()
    for pkg in ("ref", "port"):
        (tmp_path / pkg / "DEM").mkdir(parents=True)
        (tmp_path / pkg / "DEM" / "urls.csv").write_text(
            "\n".join(served) + "\n")
        final = tmp_path / pkg / "final" / "shp_gpkg"
        final.mkdir(parents=True)
        write_file(GeoDataFrame(
            {"OBJECTID": [1, 2], "geometry": [
                _rect(jcore, 2600010, 1200010, 2600190, 1200020),
                _rect(jcore, 2600050, 1200050, 2600060, 1200190)]},
            crs="EPSG:2056"), str(final / "roads.shp"))
    ref = tmp_path / "ref"
    names = jrasters.download_tiles(list(served), str(ref / "DEM"),
                                    opener=served.__getitem__)
    os.makedirs(ref / "out" / "DEM")
    jrasters.make_mosaic(str(ref / "DEM"), names,
                         str(ref / "out" / "DEM" / "DEM_aoi.tif"))
    from roadsurf_tpu.io import read_file as jread
    zs = jrasters.dem_zonal_stats(
        str(ref / "out" / "DEM" / "DEM_aoi.tif"),
        jread(str(ref / "final" / "shp_gpkg" / "roads.shp")))
    os.makedirs(ref / "out" / "shapefiles_gpkg")
    write_file(zs, str(ref / "out" / "shapefiles_gpkg" / "roads_dem_zs.shp"))

    port = tmp_path / "port"
    written = trasters.run(str(port / "DEM"), str(port / "out"),
                           str(port / "final"), "urls.csv",
                           "shp_gpkg/roads.shp", generate_mosaic=True,
                           opener=served.__getitem__)
    assert [os.path.relpath(p, port / "out") for p in written] == [
        "DEM/DEM_aoi.tif", "shapefiles_gpkg/roads_dem_zs.shp"]
    for rel in ("DEM/DEM_aoi.tif", "shapefiles_gpkg/roads_dem_zs.shp",
                "shapefiles_gpkg/roads_dem_zs.dbf"):
        assert filecmp.cmp(ref / "out" / rel, port / "out" / rel,
                           shallow=False), rel
    # the entry point, on the mosaic the run made
    assert trasters.main(["--processed-folder", str(port / "out"),
                          "--final-folder", str(port / "final"),
                          "--roads", "shp_gpkg/roads.shp"]) == 0
