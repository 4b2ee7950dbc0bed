"""Label preparation and tilesets end to end: the port's
``pipeline.label_prep.run`` then ``pipeline.tilesets.run`` (their YAML
blocks of config/config_obj_detec.yaml) against the reference package's,
each in its own directory, with one PNG opener serving the tiles.

* The fixtures' scene (tests/fixtures.py::write_data_dir): every written
  file is equal, byte for byte.
* An 8x8 jittered road grid (``chip_smoke.write_scene``, 112 segments):
  the reference's geometry core cuts some road polygons wrong there (the
  T-junction fault, ROADMAP Queue C) and buffers some forests wrong. Each
  cut and each forest buffer of the reference is held against a raster
  oracle; the roads that a wrong cut or a wrong forest reaches (directly
  or through later cuts) are "tainted". Every other road polygon and
  label equals the reference's within 1e-6 m, every untainted COCO
  annotation equals the reference's, the port's own cuts all agree with
  the oracle, and every file that holds no road geometry is equal byte
  for byte.
* The 16x16 scene through the port alone, held to the de-overlap's
  invariants by the raster oracle: the GT/OTH count, no overlap between
  roads of different rank, and the buffered roads' area kept but for
  parts under 10 m² that the cleanup drops.
* The port's training loader reads the tileset the port wrote.
"""

from __future__ import annotations

import copy
import filecmp
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import chip_smoke
import fixtures
import test_torch_geom as tg
from roadsurf_tpu.pipeline import label_prep as jlp
from roadsurf_tpu.pipeline import tilesets as jts
from roadsurf_tpu_torch.geom import _native as tn
from roadsurf_tpu_torch.geom import core as tcore
from roadsurf_tpu_torch.geom.cleanup import keep_largest_part
from roadsurf_tpu_torch.io import read_excel, read_file
from roadsurf_tpu_torch.pipeline import label_prep as tlp
from roadsurf_tpu_torch.pipeline import tilesets as tts
from roadsurf_tpu_torch.pipeline import training

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "config", "config_obj_detec.yaml")) as f:
    CONFIG = yaml.safe_load(f)
PX = 0.05            # the raster oracle's pixel, m
RANK = {20: 8.5, 21: 2.5}


def raster(g, box, px=PX) -> np.ndarray:
    """Pixel-centre fill of a (Multi)Polygon over ``box``, on a grid offset
    from round coordinates (no centre on a vertex)."""
    x0, y0, x1, y1 = box
    w, h = int(np.ceil((x1 - x0) / px)), int(np.ceil((y1 - y0) / px))
    if g is None or g.is_empty:
        return np.zeros((h, w), bool)
    polys = g.geoms if g.geom_type == "MultiPolygon" else [g]
    return tn.rasterize(tn.pack([[p.exterior_coords, *p.interiors_coords]
                                 for p in polys]),
                        x0 + 0.0137, px, y0 + 0.0291, px, h, w).astype(bool)


def has_spike(g, tol: float = 1e-8, arm: float = 1e-6) -> bool:
    """Whether a ring of ``g`` turns back on itself along one line at a
    vertex (a zero-width spike, at most ``tol`` wide, both arms longer than
    ``arm``): an invalid ring that covers no area, so no raster sees it, but
    a later boolean operation along it goes wrong (ROADMAP Queue C, fault
    (c))."""
    if g is None or g.is_empty:
        return False
    for p in (g.geoms if g.geom_type == "MultiPolygon" else [g]):
        for ring in (p.exterior_coords, *p.interiors_coords):
            r = ring[:-1] if len(ring) > 1 and (ring[0] == ring[-1]).all() \
                else ring
            r = r - r.mean(0)
            ab = r - np.roll(r, 1, 0)
            bc = np.roll(r, -1, 0) - r
            la, lb = np.hypot(*ab.T), np.hypot(*bc.T)
            cross = np.abs(ab[:, 0] * bc[:, 1] - ab[:, 1] * bc[:, 0])
            back = ((ab * bc).sum(1) < 0) & (np.minimum(la, lb) > arm)
            if (back & (cross <= tol * np.maximum(la, lb))).any():
                return True
    return False


def _cut_error(p1, p2, diff) -> float:
    """m² on which ``diff`` differs from p2 minus p1 (raster oracle);
    infinite where ``diff`` holds a zero-width spike."""
    if has_spike(diff):
        return float("inf")
    box = tuple(np.array(p2.bounds) + [-1, -1, 1, 1])
    want = raster(p2, box) & ~raster(p1, box)
    return float((want != raster(diff, box)).sum() * PX * PX)


def run_chain(label_prep, tilesets, data: str, out: str, opener=None,
              cut_log: list | None = None):
    """label_prep.run then tilesets.run on ``data`` into ``out``. Without
    an ``opener``, one is built from this run's tiles and ground truth.
    With ``cut_log``, every de-overlap cut is logged as (cutter id, cut id,
    oracle error m²). Returns the opener."""
    lp = copy.deepcopy(CONFIG["prepare_data_obj_detec.py"])
    lp["input"]["input_folder"] = data
    lp["output_folder"] = out
    with pytest.MonkeyPatch.context() as mp:
        if cut_log is not None:
            cut = label_prep.polygons_diff_without_artifacts

            def logged(polygons, i1, i2, **kw):
                p1 = polygons.loc[i1, "geometry"]
                p2 = polygons.loc[i2, "geometry"]
                cut_log.append((int(polygons.loc[i1, "OBJECTID"]),
                                int(polygons.loc[i2, "OBJECTID"]),
                                _cut_error(p1, p2, p2 - p1)))
                return cut(polygons, i1, i2, **kw)
            mp.setattr(label_prep, "polygons_diff_without_artifacts", logged)
        label_prep.run(lp)
    if opener is None:
        js = os.path.join(out, "json_inputs")
        opener = chip_smoke.MosaicOpener(
            os.path.join(js, "tiles_aoi.geojson"),
            os.path.join(js, "ground_truth_labels.geojson"), seed=4)
    ts = copy.deepcopy(CONFIG["generate_tilesets.py"])
    ts["working_directory"] = out
    ts["n_jobs"] = 4
    tilesets.run(ts, opener=opener)
    return opener


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def fixture_scene(tmp_path_factory):
    """The port's chain, then the reference's, served the port's mosaic."""
    root = tmp_path_factory.mktemp("fixture_scene")
    data = fixtures.write_data_dir(str(root / "src"))
    ref, port = str(root / "ref"), str(root / "port")
    run_chain(jlp, jts, data, ref, run_chain(tlp, tts, data, port))
    return ref, port


def test_fixture_scene_files_equal_the_reference(fixture_scene):
    ref, port = fixture_scene
    files = _files(ref)
    assert files == _files(port)
    for name in ("shapefiles_gpkg/roads_for_OD.shp",
                 "json_inputs/tiles_aoi.geojson",
                 "json_inputs/ground_truth_labels.geojson",
                 "obj_detector/split_aoi_tiles.geojson",
                 "obj_detector/COCO_trn.json", "obj_detector/COCO_oth.json",
                 "obj_detector/img_metadata.json",
                 "obj_detector/category_ids.json",
                 "obj_detector/labels_id.json"):
        assert name in files
    assert sum(f.endswith(".tif") for f in files) > 20
    differ = [f for f in files if not filecmp.cmp(
        os.path.join(ref, f), os.path.join(port, f), shallow=False)]
    assert differ == []


# ---------------------------------------------------------------------------
# the 8x8 jittered grid

def _forest_buffer_wrong(data: str) -> list:
    """The reference's 3 m forest buffers that disagree with the distance
    oracle (raster centres inside the forest or within 3 m of it) on more
    than 1 m², as port geometries."""
    from roadsurf_tpu.io import read_file as jread
    wrong = []
    px = 0.25
    for f in jread(os.path.join(data, "swissTLM3D", "forests.shp")) \
            .geometry.values:
        forest, buf = _to_port(f), _to_port(f.buffer(3))
        x0, y0, x1, y1 = np.array(f.bounds) + [-5, -5, 5, 5]
        xs = x0 + 0.0137 + px * np.arange(int(np.ceil((x1 - x0) / px)))
        ys = y0 + 0.0291 + px * np.arange(int(np.ceil((y1 - y0) / px)))
        pts = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
        truth = tg._within(pts, forest, 3.0).reshape(len(ys), len(xs))
        if float((truth != raster(buf, (x0, y0, x1, y1), px)).sum()) \
                * px * px > 1:
            wrong.append(buf)
    return wrong


def _to_port(g):
    if g.geom_type == "Polygon":
        return tcore.Polygon(g.exterior_coords, g.interiors_coords)
    return tcore.MultiPolygon([tcore.Polygon(p.exterior_coords,
                                             p.interiors_coords)
                               for p in g.geoms])


def _taint(cut_log, roads, wrong_forests) -> set:
    """Road ids a wrong cut or a wrong forest buffer reaches."""
    tainted = set()
    for cutter, cut, err in cut_log:
        if err > 0.5 or cutter in tainted:
            tainted.add(cut)
    for g, oid in zip(roads.geometry.values, roads["OBJECTID"]):
        if any(g.intersects(f) for f in wrong_forests):
            tainted.add(int(oid))
    return tainted


@pytest.fixture(scope="module")
def grid_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid_scene")
    data = chip_smoke.write_scene(str(root / "src"), n=8, seed=0)
    ref, port = str(root / "ref"), str(root / "port")
    port_cuts, ref_cuts = [], []
    opener = run_chain(tlp, tts, data, port, cut_log=port_cuts)
    run_chain(jlp, jts, data, ref, opener, ref_cuts)
    roads = read_file(os.path.join(port, "shapefiles_gpkg",
                                   "roads_for_OD.shp"))
    tainted = _taint(ref_cuts, roads, _forest_buffer_wrong(data))
    return data, ref, port, port_cuts, ref_cuts, tainted


def _verts(g) -> np.ndarray:
    polys = g.geoms if g.geom_type == "MultiPolygon" else [g]
    return np.concatenate([r for p in polys
                           for r in (p.exterior_coords, *p.interiors_coords)])


def _close(a, b, tol: float) -> bool:
    va, vb = _verts(a), _verts(b)
    d = np.abs(va[:, None, :] - vb[None, :, :]).max(-1)
    return bool(d.min(1).max() <= tol and d.min(0).max() <= tol)


@pytest.mark.parametrize("name,tol", [
    ("shapefiles_gpkg/roads_for_OD.shp", 1e-6),
    ("json_inputs/ground_truth_labels.geojson", 1e-11),
    ("json_inputs/other_labels.geojson", 1e-11)])
def test_grid_scene_roads_and_labels_equal_the_reference(grid_scene, name,
                                                         tol):
    _, ref, port, port_cuts, ref_cuts, tainted = grid_scene
    assert port_cuts and all(err <= 0.5 for _, _, err in port_cuts)
    assert any(err > 0.5 for _, _, err in ref_cuts)   # the reference's fault
    if not os.path.exists(os.path.join(ref, name)):
        assert not os.path.exists(os.path.join(port, name))
        return
    from roadsurf_tpu.io import read_file as jread
    r, p = jread(os.path.join(ref, name)), read_file(os.path.join(port, name))
    assert list(r.columns) == list(p.columns)
    assert str(r.crs) == str(p.crs)
    attrs = [c for c in r.columns if c != "geometry"]
    pd.testing.assert_frame_equal(pd.DataFrame(r[attrs]),
                                  pd.DataFrame(p[attrs]))
    kept = 0
    for a, b, oid in zip(r.geometry.values, p.geometry.values, p["OBJECTID"]):
        if int(oid) in tainted:
            continue
        assert _close(a, b, tol), oid
        kept += 1
    assert kept >= 0.8 * len(p)


def _ring(values) -> np.ndarray:
    """A COCO ring as (N, 2) pixel points without repeated consecutive
    points (the reference's clip can repeat a vertex)."""
    pts = np.asarray(values).reshape(-1, 2)
    keep = np.ones(len(pts), bool)
    keep[1:] = np.abs(np.diff(pts, axis=0)).max(1) > 0.011
    return pts[keep]


def test_grid_scene_tilesets_equal_the_reference(grid_scene):
    _, ref, port, _, _, tainted = grid_scene
    od = "obj_detector"
    files = _files(ref)
    assert files == _files(port)
    geometry_files = {"shapefiles_gpkg/roads_for_OD.shp",
                      "shapefiles_gpkg/roads_for_OD.shx",
                      "json_inputs/ground_truth_labels.geojson",
                      "json_inputs/other_labels.geojson"} | {
        f"{od}/COCO_{ds}.json" for ds in tts.DATASETS}
    differ = [f for f in files if f not in geometry_files and not filecmp.cmp(
        os.path.join(ref, f), os.path.join(port, f), shallow=False)]
    assert differ == []
    # COCO: the same images and categories; the annotations of a tile no
    # tainted label reaches equal the reference's
    labels = read_file(os.path.join(port, "json_inputs",
                                    "ground_truth_labels.geojson"))
    split = read_file(os.path.join(port, od, "split_aoi_tiles.geojson"))
    bad_tiles = {tid for tid, tile in zip(split["id"], split.geometry.values)
                 if any(g.intersects(tile) for g, oid in zip(
                     labels.geometry.values, labels["OBJECTID"])
                        if int(oid) in tainted)}
    compared = 0
    for ds in ("trn", "val", "tst"):
        with open(os.path.join(ref, od, f"COCO_{ds}.json")) as f:
            want = json.load(f)
        with open(os.path.join(port, od, f"COCO_{ds}.json")) as f:
            got = json.load(f)
        assert got["images"] == want["images"]
        assert got["categories"] == want["categories"]
        tile_of = {im["id"]: im["file_name"] for im in got["images"]}
        ids = {f"18_{x}_{y}.tif": f"({x}, {y}, 18)" for x, y in (
            (int(s) for s in tid.strip("()").split(", ")[:2])
            for tid in split["id"])}
        for im in got["images"]:
            if ids[tile_of[im["id"]]] in bad_tiles:
                continue
            a = [x for x in want["annotations"] if x["image_id"] == im["id"]]
            b = [x for x in got["annotations"] if x["image_id"] == im["id"]]
            assert len(a) == len(b), im
            for x, y in zip(a, b):
                assert x["category_id"] == y["category_id"]
                assert len(x["segmentation"]) == len(y["segmentation"])
                for rx, ry in zip(x["segmentation"], y["segmentation"]):
                    np.testing.assert_allclose(_ring(rx), _ring(ry),
                                               atol=0.011)
            compared += len(b)
    assert compared > 0


# ---------------------------------------------------------------------------
# the 16x16 grid through the port alone

def test_dense_grid_deoverlap_invariants(tmp_path):
    data = chip_smoke.write_scene(str(tmp_path), n=16, seed=0)
    roads = read_file(os.path.join(data, "swissTLM3D", "roads_lines.shp"))
    params = read_excel(os.path.join(data, "roads_parameters.xlsx"))
    empty = type(roads)({"UUID": [], "geometry": []}, crs=2056)
    out = tlp.determine_road_surfaces(roads, empty, params)
    # GT/OTH: every labelled road is ground truth or other
    lp = copy.deepcopy(CONFIG["prepare_data_obj_detec.py"])
    lp["input"]["input_folder"] = data
    lp["output_folder"] = str(tmp_path / "out")
    tlp.run(lp)
    js = tmp_path / "out" / "json_inputs"
    nfr = read_file(str(tmp_path / "out" / "shapefiles_gpkg"
                        / "roads_for_OD.shp"))
    n_oth = (len(read_file(str(js / "other_labels.geojson")))
             if (js / "other_labels.geojson").exists() else 0)
    assert len(read_file(str(js / "ground_truth_labels.geojson"))) + n_oth \
        == int(nfr["BELAGSART"].isin([100, 200]).sum())

    geoms, ids = list(out.geometry.values), [int(i) for i in out["OBJECTID"]]
    ranks = [RANK.get(int(o), float(o)) for o in out["OBJEKTART"]]
    bounds = [g.bounds for g in geoms]
    for i in range(len(geoms)):
        for j in range(i + 1, len(geoms)):
            a, b = bounds[i], bounds[j]
            box = (max(a[0], b[0]), max(a[1], b[1]),
                   min(a[2], b[2]), min(a[3], b[3]))
            if ranks[i] == ranks[j] or box[0] >= box[2] or box[1] >= box[3]:
                continue
            assert not (raster(geoms[i], box) & raster(geoms[j], box)).any(), \
                (ids[i], ids[j])
    # each road's buffer is covered by the de-overlapped polygons, but for
    # parts under 10 m² (the cleanup drops those), and no polygon leaves
    # its road's buffer
    width = dict(zip(params["GDB-Code"], params["Width"]))
    line = dict(zip(roads["OBJECTID"], roads.geometry.values))
    cls = dict(zip(roads["OBJECTID"], roads["OBJEKTART"]))
    from scipy import ndimage
    seen = set()
    for i, oid in enumerate(ids):
        if oid in seen or oid not in line:
            continue
        seen.add(oid)
        buf = keep_largest_part(line[oid].buffer(width[cls[oid]] / 2,
                                                 cap_style=2))
        box = tuple(np.array(buf.bounds) + [-1, -1, 1, 1])
        mb = raster(buf, box)
        assert not (raster(geoms[i], box) & ~mb).any(), oid
        cover = np.zeros_like(mb)
        for j, b in enumerate(bounds):
            if b[0] <= box[2] and b[2] >= box[0] and b[1] <= box[3] \
                    and b[3] >= box[1]:
                cover |= raster(geoms[j], box)
        lab, n = ndimage.label(mb & ~cover)
        if n:
            sizes = ndimage.sum(np.ones_like(lab), lab, range(1, n + 1))
            assert sizes.max() * PX * PX < 10, oid


def test_training_loader_reads_the_written_tileset(grid_scene):
    _, _, port, _, _, _ = grid_scene
    od = os.path.join(port, "obj_detector")
    ds = training.CocoTileDataset(os.path.join(od, "COCO_trn.json"),
                                  os.path.join(od, "trn-images"), 16)
    assert len(ds) > 4
    batch = training.make_batch(ds, np.random.default_rng(0),
                                np.arange(4), augment=False)
    assert batch["image"].shape == (4, 256, 256, 3)
    assert batch["gt_valid"].any()
    assert batch["gt_masks"].any()
