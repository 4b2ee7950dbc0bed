"""The statistical branch end to end: config/config_stats.yaml's chain
(``pipeline.stats_prep``, ``pipeline.label_prep`` over its polygons,
``pipeline.tilesets`` from a 4-band tile service, ``pipeline.stats_analysis``)
in the port (``chip_smoke.stats_chain``, the PCAs on the CPU) against the
reference package's stages, each in its own directory.

* The fixtures' scene (tests/fixtures.py::write_data_dir): stats_prep's
  and label preparation's files equal the reference's byte for byte. The
  reference's analysis, run on a copy of the port's workspace, writes the
  port's files byte for byte, the PCA tables held to test_torch_stats.py's
  rule (and a component of zero variance, a direction of the null space
  that any basis spans, left out of the matrices).
* The reference's own tile fetch drops the NIR band of the 4-band TIFF
  tiles (Pillow reads them as RGB), so its analysis cannot run on its own
  tileset; the port decodes them itself and keeps the four bands.
* The 20x20 grid of ``chip_smoke.stats_path``: one road polygon turns
  invalid when reprojected to EPSG:3857 (a self-intersection), which the
  analysis repairs with buffer(0) (fault (b)'s code path): the port's
  repair agrees with the point oracle (the polygon's own fill), and with
  the reference's where that agrees too.
* An 8x8 jittered road grid (``chip_smoke.write_scene``): the reference's
  stats_prep raises there (a cut removes a road whole: the empty
  difference the port repairs, ROADMAP Queue C), so the port is held to
  oracles. Its restricted AOI agrees with the raster and distance oracle
  (``chip_smoke.aoi_oracle``: within 4.5 m of a road line, not within 3 m
  of a forest) but for a few m², with one hole for each field no forest
  reaches; the reference's restricted AOI on the same road lines loses most
  of them (fault (a)). No two of the port's road polygons overlap. The
  reference's analysis on a copy of the port's workspace writes the port's
  tables. No reprojected road polygon is invalid there.
"""

from __future__ import annotations

import copy
import csv
import filecmp
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import fixtures
from roadsurf_tpu.pipeline import label_prep as jlp
from roadsurf_tpu.pipeline import stats_analysis as jsa
from roadsurf_tpu.pipeline import stats_prep as jsp
from roadsurf_tpu.pipeline import tilesets as jts
from roadsurf_tpu_torch.io import read_excel, read_file, read_geotiff
from roadsurf_tpu_torch.pipeline import label_prep as tlp
from roadsurf_tpu_torch.pipeline import stats_analysis as tsa
from roadsurf_tpu_torch.pipeline import stats_prep as tsp
from roadsurf_tpu_torch.pipeline import tilesets as tts
from roadsurf_tpu_torch.stats import pca as tpca
from test_torch_stats import _near_boundary

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "config", "config_stats.yaml")) as f:
    CONFIG = yaml.safe_load(f)


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _port_chain(data: str, root, ks: bool) -> tuple[str, list]:
    """The port's chain into ``root/port``; returns it and the frames its
    analysis handed to ``pca_procedure`` (the tables' prefix, the frame,
    the features)."""
    calls = []
    procedure = tsa.pca_procedure

    def logged(dataset, features, to_describe, dirpath_tables,
               dirpath_images, file_prefix, *a, **kw):
        calls.append((file_prefix, dataset.copy(), list(features)))
        return procedure(dataset, features, to_describe, dirpath_tables,
                         dirpath_images, file_prefix, *a, **kw)

    out = str(root / "port")
    (root / "tmp").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsa, "pca_procedure", logged)
        chip_smoke.stats_chain((tsp, tlp, tts, tsa), data, out,
                               str(root / "tmp"), ks=ks,
                               analysis_kw={"device": "cpu"})
    return out, calls


def _reference_analysis(port: str, root, ks: bool) -> str:
    """The reference's analysis on a copy of the port's workspace (its
    inputs only)."""
    ana = str(root / "ref_analysis")
    shutil.copytree(port, ana, ignore=shutil.ignore_patterns("final",
                                                             "tables"))
    sa = copy.deepcopy(CONFIG["statistical_analysis.py"])
    sa["processed"]["processed_folder"] = ana
    sa["final_folder"] = os.path.join(ana, "final")
    sa["param"]["do_ks_test"] = ks
    jsa.run(sa)
    return ana


def _pca_cells_differing(ref_dir, port_dir, calls) -> tuple[int, int]:
    """Compare each PCA's three tables: equal text but for printed values
    within 1e-9 of a rounding boundary, one unit of the last digit apart.
    The columns of a component of zero variance are left out of the
    matrices (its coordinates are within 1e-9 of 0). A component whose two
    largest |loadings| tie (to ``pca.TIE``) may come out with the other
    sign, the tie's choice being the eigensolver's rounding: its columns
    are then compared negated. Returns (the count of values near a
    boundary, of components compared negated)."""
    near = flipped = 0
    for prefix, frame, feats in calls:
        pca, coor = tpca.calculate_pca(frame, feats, "road_type", None,
                                       device="cpu")
        ev = pca.explained_variance_
        determined = ev > 1e-10 * ev[0]
        top2 = -np.sort(-np.abs(pca.components_), 1)[:, :2]
        tied = top2[:, 1] >= top2[:, 0] * (1 - tpca.TIE)
        tables = {"corr_matrix.csv": pca.components_.T,
                  "loading_matrix.csv":
                      pca.components_.T * np.sqrt(pca.explained_variance_),
                  "values.csv": coor}
        sign = np.ones(len(ev))
        for suffix, values in tables.items():
            name = os.path.join("final", "tables", prefix + suffix)
            with open(os.path.join(ref_dir, name)) as fa, \
                    open(os.path.join(port_dir, name)) as fb:
                ra, rb = list(csv.reader(fa)), list(csv.reader(fb))
            assert len(ra) == len(rb) and ra[0] == rb[0], name
            first = 0 if suffix == "values.csv" else 1
            if suffix == "corr_matrix.csv":
                for col in np.flatnonzero(tied & determined):
                    if all(float(la[first + col]) == -float(lb[first + col])
                           != 0 or float(la[first + col]) == 0
                           for la, lb in zip(ra[1:], rb[1:])):
                        sign[col] = -1
                        flipped += 1
            for i, (la, lb) in enumerate(zip(ra[1:], rb[1:])):
                assert la[:first] == lb[:first] and len(la) == len(lb)
                for j in range(first, len(la)):
                    a, b = la[j], lb[j]
                    col = j - first
                    if col >= values.shape[1]:      # the class column
                        assert a == b, (name, i, j, a, b)
                        continue
                    if suffix != "values.csv" and not determined[col]:
                        continue
                    got = sign[col] * float(b)
                    if float(a) == got and (a == b or sign[col] < 0):
                        continue
                    d = len(a.split(".")[1]) if "." in a else 0
                    assert abs(float(a) - got) <= 10 ** -d + 1e-12, \
                        (name, i, j, a, b)
                    assert _near_boundary(values[i, col], d), \
                        (name, i, j, a, b, values[i, col])
                    near += 1
    return near, flipped


# ---------------------------------------------------------------------------
# the fixtures' scene

@pytest.fixture(scope="module")
def fixture_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("stats_fixture_scene")
    data = fixtures.write_data_dir(str(root / "src"))
    port, calls = _port_chain(data, root, ks=True)
    ref = str(root / "ref")
    for block, stage in (("prepare_data.py", jsp),
                         ("prepare_data_obj_detec.py", jlp)):
        cfg = copy.deepcopy(CONFIG[block])
        cfg["input"]["input_folder"] = data
        cfg["output_folder"] = ref
        stage.run(cfg)
    return root, port, ref, calls


def test_fixture_scene_preparation_equals_the_reference(fixture_scene):
    _, port, ref, _ = fixture_scene
    files = _files(ref)
    assert {"shapefiles_gpkg/roads_polygons_stats.shp",
            "shapefiles_gpkg/restricted_AOI.shp",
            "json_inputs/tiles_aoi.geojson"} <= set(files)
    assert [f for f in files if not filecmp.cmp(
        os.path.join(ref, f), os.path.join(port, f), shallow=False)] == []


def test_fixture_scene_analysis_equals_the_reference(fixture_scene):
    root, port, _, calls = fixture_scene
    ana = _reference_analysis(port, root, ks=True)
    written = [f for f in _files(port)
               if f.startswith(("final", "tables"))]
    assert written == [f for f in _files(ana)
                       if f.startswith(("final", "tables"))]
    assert {"tables/stats_roads.csv", "final/tables/ks_test.csv",
            "final/tables/statistics_roads_by_type.csv",
            "final/images/boxplot_pixel_in_bands.webp",
            "final/tables/PCA_pixels_values.csv"} <= set(written)
    assert [c[0] for c in calls] == ["PCA_pixels_"] + [
        f"PCA_stats_band_{b}_" for b in ("red", "green", "blue", "NIR")]
    pca_tables = {os.path.join("final", "tables", p + s) for p, _, _ in calls
                  for s in ("values.csv", "loading_matrix.csv",
                            "corr_matrix.csv")}
    # every other file, figures included, byte for byte
    assert [f for f in written if f not in pca_tables and not filecmp.cmp(
        os.path.join(port, f), os.path.join(ana, f), shallow=False)] == []
    # measured: 11 printed zeros of another sign (the coordinates on the
    # components of zero variance: 5 roads, 6 features), no tie
    near, flipped = _pca_cells_differing(ana, port, calls)
    assert near <= 20 and flipped == 0, (near, flipped)


def test_the_references_fetch_drops_the_nir_band(fixture_scene, tmp_path):
    """Queue C: the reference decodes every tile with Pillow, which reads
    the 4-band TIFF tiles as RGB; the port keeps R, G, B and NIR."""
    root, port, _, _ = fixture_scene
    ref = str(tmp_path / "ref")
    shutil.copytree(port, ref, ignore=shutil.ignore_patterns(
        "final", "tables", "obj_detector"))
    ts = copy.deepcopy(CONFIG["generate_tilesets.py"])
    ts["working_directory"] = ref
    opener = chip_smoke.BandsOpener(
        os.path.join(ref, "json_inputs", "tiles_aoi.geojson"),
        read_file(os.path.join(ref, "shapefiles_gpkg",
                               "roads_polygons_stats.shp")), 6,
        str(tmp_path))
    jts.run(ts, opener=opener)
    name = sorted(os.listdir(os.path.join(port, "obj_detector",
                                          "all-images")))[0]
    got = read_geotiff(os.path.join(port, "obj_detector", "all-images",
                                    name)).data
    want = read_geotiff(os.path.join(ref, "obj_detector", "all-images",
                                     name)).data
    assert got.shape[2] == 4 and want.shape[2] == 3
    np.testing.assert_array_equal(got[:, :, :3], want)
    sa = copy.deepcopy(CONFIG["statistical_analysis.py"])
    sa["processed"]["processed_folder"] = ref
    sa["final_folder"] = os.path.join(ref, "final")
    with pytest.raises(IndexError):
        jsa.run(sa)


# ---------------------------------------------------------------------------
# the 8x8 grid

@pytest.fixture(scope="module")
def grid_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("stats_grid_scene")
    data = chip_smoke.write_scene(str(root / "src"), n=8, seed=0)
    port, calls = _port_chain(data, root, ks=False)
    return root, data, port, calls


def test_grid_scene_restricted_aoi_against_the_oracle(grid_scene):
    from roadsurf_tpu.geom import core as jcore
    from roadsurf_tpu.geom.table import GeoDataFrame as JFrame
    from roadsurf_tpu_torch.geom import core as tcore

    _, data, port, _ = grid_scene
    roads = read_file(os.path.join(data, "swissTLM3D", "roads_lines.shp"))
    forests = read_file(os.path.join(data, "swissTLM3D", "forests.shp"))
    aoi = read_file(os.path.join(data, "AOI", "aoi.shp"))
    params = read_excel(os.path.join(data, "roads_parameters.xlsx"))
    # the reference's stats_prep raises on this scene (the empty difference)
    with pytest.raises(ValueError, match="empty"):
        jsp.determine_road_surfaces_stats(
            _to_ref(roads), _to_ref(forests), params, _to_ref(aoi))
    _, in_aoi = tsp.determine_road_surfaces_stats(roads, forests, params,
                                                  aoi)
    width = (params["Width"].max() + 1) / 2
    oracle = chip_smoke.aoi_oracle(in_aoi.geometry.values,
                                   forests.geometry.values, width)
    raoi = read_file(os.path.join(port, "shapefiles_gpkg",
                                  "restricted_AOI.shp"))
    got = chip_smoke.aoi_agreement(raoi.geometry.values, oracle)
    assert got["mismatch_m2"] <= 0.001 * got["oracle_m2"], got
    assert got["fields_free"] >= 30 and got["holes"] >= got["fields_free"]
    # the reference's restricted AOI of the same road lines
    want = jsp.determine_restricted_aoi(
        JFrame({"geometry": [jcore.LineString(g.coords_array)
                             for g in in_aoi.geometry.values]},
               crs="EPSG:2056"), _to_ref(forests), params)
    ref = chip_smoke.aoi_agreement(
        [tcore.MultiPolygon([tcore.Polygon(p.exterior_coords,
                                           p.interiors_coords)
                             for p in (g.geoms if g.geom_type ==
                                       "MultiPolygon" else [g])])
         for g in want.geometry.values], oracle)
    assert ref["mismatch_m2"] > 0.5 * ref["oracle_m2"], ref
    assert ref["holes"] < got["fields_free"] // 2, ref


def _to_ref(frame):
    """A port frame of lines or polygons as the reference's."""
    from roadsurf_tpu.geom import core as jcore
    from roadsurf_tpu.geom.table import GeoDataFrame as JFrame

    def conv(g):
        if g.geom_type == "LineString":
            return jcore.LineString(g.coords_array)
        return jcore.Polygon(g.exterior_coords, g.interiors_coords)

    cols = {c: list(frame[c]) for c in frame.columns if c != "geometry"}
    return JFrame({**cols, "geometry": [conv(g)
                                        for g in frame.geometry.values]},
                  crs="EPSG:2056")


def test_grid_scene_road_polygons_do_not_overlap(grid_scene):
    _, _, port, _ = grid_scene
    polys = read_file(os.path.join(port, "shapefiles_gpkg",
                                   "roads_polygons_stats.shp"))
    geoms = list(polys.geometry.values)
    assert len(geoms) > 80 and all(not g.is_empty for g in geoms)
    bounds = [g.bounds for g in geoms]
    worst = 0.0
    for i in range(len(geoms)):
        for j in range(i + 1, len(geoms)):
            a, b = bounds[i], bounds[j]
            if a[0] > b[2] or b[0] > a[2] or a[1] > b[3] or b[1] > a[3]:
                continue
            worst = max(worst, (geoms[i] & geoms[j]).area)
    assert worst <= 1.0, worst
    assert int((~polys.to_crs(epsg=3857).is_valid).sum()) == 0


def test_grid_scene_analysis_equals_the_reference(grid_scene):
    root, _, port, calls = grid_scene
    ana = _reference_analysis(port, root, ks=False)
    written = [f for f in _files(port) if f.startswith(("final", "tables"))
               and f.endswith(".csv")]
    assert written == [f for f in _files(ana)
                       if f.startswith(("final", "tables"))
                       and f.endswith(".csv")]
    pca_tables = {os.path.join("final", "tables", p + s) for p, _, _ in calls
                  for s in ("values.csv", "loading_matrix.csv",
                            "corr_matrix.csv")}
    assert [f for f in written if f not in pca_tables and not filecmp.cmp(
        os.path.join(port, f), os.path.join(ana, f), shallow=False)] == []
    assert len(calls[0][1]) > 100000          # the pixel rows
    # measured: 150 printed zeros of another sign (coordinates within 1e-9
    # of 0), no other value; the blue band's road statistics hold a tied
    # component (loadings +-0.71), which came out with scikit-learn's sign
    near, flipped = _pca_cells_differing(ana, port, calls)
    assert near <= 300 and flipped <= 1, (near, flipped)


def test_the_analysis_repairs_reprojected_roads_as_the_oracle(tmp_path):
    """The 20x20 scene's road polygons in EPSG:3857, as the analysis
    reads them: each invalid one's buffer(0) (``stats_analysis.run``'s
    repair) against the point oracle, 200,000 points over its box."""
    from roadsurf_tpu.geom import core as jcore
    from roadsurf_tpu_torch.geom import _native as tn

    data = chip_smoke.write_scene(str(tmp_path))
    roads = read_file(os.path.join(data, "swissTLM3D", "roads_lines.shp"))
    forests = read_file(os.path.join(data, "swissTLM3D", "forests.shp"))
    aoi = read_file(os.path.join(data, "AOI", "aoi.shp"))
    params = read_excel(os.path.join(data, "roads_parameters.xlsx"))
    polys, _ = tsp.determine_road_surfaces_stats(roads, forests, params,
                                                 aoi)
    assert polys.is_valid.all()
    p3857 = polys.to_crs(epsg=3857)
    bad = [g for g, ok in zip(p3857.geometry.values, p3857.is_valid)
           if not ok]
    assert len(bad) >= 1               # measured: one, road 476's
    rng = np.random.default_rng(17)

    def fill(g, pts):
        parts = g.geoms if g.geom_type == "MultiPolygon" else [g]
        return tn.points_in_polyset(pts, tn.pack(
            [[p.exterior_coords, *p.interiors_coords] for p in parts])) \
            .astype(bool)

    for g in bad:
        pts = rng.uniform(g.bounds[:2], g.bounds[2:], (200000, 2))
        truth = fill(g, pts)
        got = g.buffer(0)
        assert got.is_valid and (fill(got, pts) != truth).sum() == 0
        want = jcore.Polygon(g.exterior_coords,
                             g.interiors_coords).buffer(0)
        if (fill(want, pts) != truth).sum() == 0:
            assert got.area == want.area
