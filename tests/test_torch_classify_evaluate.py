"""The port's classify, evaluate and assess stages (``roadsurf_tpu_torch/
pipeline/{classify,evaluate,assess}.py``, ``viz/``) against the reference
package's, on the CPU.

1. Every case of tests/test_evaluate.py and tests/test_assess.py runs
   through the port (the same source, its imports pointed at the port).
2. test_e2e_pipeline.py's two runs on one workspace (label preparation,
   tilesets and a perfect detector's files, made once): ``classify.run``
   and ``evaluate.run`` of each package, each in its own copy of the
   workspace. Every file they write (the class shapefiles, the metric
   CSVs, the six chart HTML files) is equal byte for byte, and the perfect
   detector scores balanced F1 1.0 in both.
3. ``get_roads_in_quarries`` buffers the quarries by 5 m, where the
   geometry core's buffer can be wrong (ROADMAP Queue C): on seeded random
   quarries, with and without holes, every 5 m buffer of the port agrees
   with the distance oracle (its 32-gon arcs' band excepted), where the
   reference's misses on about half of them; where the two buffers are
   equal, so are the roads found in the quarries.

Tolerances: none; every comparison is exact, the oracle's band aside.
"""

from __future__ import annotations

import copy
import functools
import inspect
import os
import re
import shutil
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from roadsurf_tpu.geom import core as jcore
from roadsurf_tpu.geom.table import GeoDataFrame as JFrame
from roadsurf_tpu.pipeline import classify as jclassify
from roadsurf_tpu.pipeline import evaluate as jevaluate
from roadsurf_tpu_torch.geom import _native as tn
from roadsurf_tpu_torch.geom import core as tcore
from roadsurf_tpu_torch.geom.table import GeoDataFrame as TFrame
from roadsurf_tpu_torch.pipeline import classify as tclassify
from roadsurf_tpu_torch.pipeline import evaluate as tevaluate
from test_torch_geom import _within, geom_key, random_pairs

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
REFERENCE_CASES = ("test_evaluate.py", "test_assess.py")


# ---------------------------------------------------------------------------
# 1. the reference's tests of these stages, through the port

def _reference_cases():
    cases = []
    for fname in REFERENCE_CASES:
        src = (TESTS / fname).read_text()
        names = re.findall(r"^def (test_\w+)\(", src, re.M)
        assert len(names) == len(re.findall(r"^def test_", src, re.M))
        cases += [(fname, n) for n in names]
    return cases


@functools.lru_cache(maxsize=None)
def _port_module(fname: str) -> types.ModuleType:
    """The reference's test module with every ``roadsurf_tpu`` import
    pointed at ``roadsurf_tpu_torch``."""
    src = re.sub(r"\broadsurf_tpu\b", "roadsurf_tpu_torch",
                 (TESTS / fname).read_text())
    mod = types.ModuleType(f"port_{fname[:-3]}")
    mod.__file__ = str(TESTS / fname)
    exec(compile(src, f"<{fname} through the port>", "exec"), mod.__dict__)
    return mod


def test_the_reference_cases_are_all_collected():
    """9 cases of test_evaluate.py and 2 of test_assess.py."""
    counts = {f: sum(c[0] == f for c in _reference_cases())
              for f in REFERENCE_CASES}
    assert counts == {"test_evaluate.py": 9, "test_assess.py": 2}


@pytest.mark.parametrize("fname,name", _reference_cases())
def test_reference_case_holds_in_the_port(fname, name, tmp_path):
    fn = getattr(_port_module(fname), name)
    params = inspect.signature(fn).parameters
    assert set(params) <= {"tmp_path"}, params
    fn(**({"tmp_path": tmp_path} if params else {}))


# ---------------------------------------------------------------------------
# 2. determine_class and final_metrics on one workspace, both packages

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """test_e2e_pipeline.py's workspace: the fixtures' scene with a quarry
    far away, label preparation, tilesets of flat grey PNG tiles, and a
    perfect detector's gpkg files (the clipped ground truth at score
    0.95), made once with the reference's stages."""
    import io

    from PIL import Image

    from fixtures import write_data_dir
    from roadsurf_tpu.geom.core import Polygon
    from roadsurf_tpu.geom.table import GeoDataFrame
    from roadsurf_tpu.io import read_file, write_file
    from roadsurf_tpu.pipeline import label_prep, tilesets

    def png_opener(url):
        buf = io.BytesIO()
        Image.fromarray(np.full((256, 256, 3), 128, np.uint8)).save(
            buf, format="PNG")
        return buf.getvalue()

    root = str(tmp_path_factory.mktemp("e2e"))
    write_data_dir(root)
    qdir = os.path.join(root, "data", "quarries")
    os.makedirs(qdir, exist_ok=True)
    write_file(GeoDataFrame(
        {"geometry": [Polygon([(2500000, 1100000), (2500100, 1100000),
                               (2500100, 1100100), (2500000, 1100100)])]},
        crs="EPSG:2056"), os.path.join(qdir, "quarries.shp"))
    with open(ROOT / "config" / "config_obj_detec.yaml") as f:
        cfg = yaml.safe_load(f)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        label_prep.run(cfg["prepare_data_obj_detec.py"])
        tilesets.run(cfg["generate_tilesets.py"], opener=png_opener)
        od = "outputs/obj_detector"
        split = read_file(os.path.join(od, "split_aoi_tiles.geojson"))
        gt = read_file("outputs/json_inputs/ground_truth_labels.geojson")
        clipped = tilesets.clip_labels(
            gt.to_crs(epsg=3857),
            split.to_crs(epsg=3857)[["id", "geometry"]])
        ds_of_tile = dict(zip(split["id"], split["dataset"]))
        clipped["dataset"] = [ds_of_tile[t] for t in clipped["tile_id"]]
        for ds in ("trn", "val", "tst", "oth"):
            sel = clipped[clipped["dataset"] == ds]
            det = GeoDataFrame({
                "geometry": list(sel["geometry"].values),
                "score": [0.95] * len(sel),
                "det_class": [0 if c == "artificial" else 1
                              for c in sel["CATEGORY"]],
            }, crs="EPSG:3857")
            det = det.to_crs(epsg=4326) if len(det) else det
            write_file(det, os.path.join(
                od, f"{ds}_detections_at_0dot05_threshold.gpkg"),
                layer=f"{ds}_detections")
    finally:
        os.chdir(cwd)
    return root, cfg


def _run_in_copy(workspace, dest, fn):
    """``fn()`` with the working directory in a copy of the workspace;
    returns {relative path: bytes} of what it wrote under outputs/final."""
    root, _ = workspace
    shutil.copytree(root, dest)
    cwd = os.getcwd()
    os.chdir(dest)
    try:
        fn()
    finally:
        os.chdir(cwd)
    final = os.path.join(dest, "outputs", "final")
    out = {}
    for d, _, files in os.walk(final):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, final)] = fh.read()
    return out


def _determine_class_block(cfg):
    """test_e2e_pipeline.py's block: the ground-truth roads against the
    validation detections (the scene has no inference-only labels)."""
    dc = dict(cfg["determine_class.py"])
    dc["inputs"] = dict(dc["inputs"],
                        roads="json_inputs/ground_truth_labels.geojson",
                        detections="obj_detector/"
                                   "val_detections_at_0dot05_threshold.gpkg")
    return dc


def test_determine_class_writes_the_references_files(workspace, tmp_path):
    _, cfg = workspace
    dc = _determine_class_block(cfg)
    ref = _run_in_copy(workspace, tmp_path / "ref",
                       lambda: jclassify.run(dc))
    got = _run_in_copy(workspace, tmp_path / "port",
                       lambda: tclassify.run(dc))
    assert "shp_gpkg/types_from_detections.shp" in got
    assert sorted(got) == sorted(ref)
    assert [f for f in got if got[f] != ref[f]] == []


def test_final_metrics_writes_the_references_files(workspace, tmp_path):
    """A perfect detector: balanced F1 1.0 on val and on all datasets, the
    baseline below it, every road of its class; the class shapefiles, the
    two metric CSVs and the six HTML charts equal byte for byte."""
    _, cfg = workspace
    fm = cfg["final_metrics.py"]
    ref = _run_in_copy(workspace, tmp_path / "ref",
                       lambda: jevaluate.run(fm))
    got = _run_in_copy(workspace, tmp_path / "port",
                       lambda: tevaluate.run(fm))
    assert sorted(got) == sorted(ref)
    assert [f for f in got if got[f] != ref[f]] == []
    assert sum(f.endswith(".html") for f in got) == 6
    assert {"tables/by_class_metrics.csv", "tables/global metrics.csv",
            "shp_gpkg/types_from_detections.shp"} <= set(got)
    gm = pd.read_csv(tmp_path / "port" / "outputs" / "final" / "tables"
                     / "global metrics.csv")
    f1b = dict(zip(gm["dataset"], gm["f1b"]))
    assert f1b["val"] == pytest.approx(1.0)
    assert f1b["all datasets"] == pytest.approx(1.0)
    assert f1b["baseline"] < 1.0


def test_the_entry_points_read_their_yaml_blocks(workspace, tmp_path):
    """``python -m roadsurf_tpu_torch.pipeline.{classify,evaluate}``'s
    ``main`` on the repository's YAML: the same files as ``run`` on the
    block."""
    _, cfg = workspace
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump({"determine_class.py": _determine_class_block(cfg),
                        "final_metrics.py": cfg["final_metrics.py"]}, f,
                       sort_keys=False)
    via_main = _run_in_copy(workspace, tmp_path / "main", lambda: (
        tclassify.main([str(path)]), tevaluate.main([str(path)])))
    via_run = _run_in_copy(workspace, tmp_path / "run", lambda: (
        tclassify.run(_determine_class_block(cfg)),
        tevaluate.run(cfg["final_metrics.py"])))
    assert sorted(via_main) == sorted(via_run)
    assert [f for f in via_main if via_main[f] != via_run[f]] == []


def test_final_metrics_scores_the_same_in_any_order_of_its_files(
        workspace, tmp_path):
    """Fault (d): the ``to_evaluate`` block in sorted order (as a YAML
    rewritten with sorted keys has it) reads the empty ``oth`` file first,
    which the workspace holds in EPSG:3857 as the reference's
    make_detections writes it. The reference takes that file's CRS for
    every detection, finds none on a road and scores balanced F1 0.0; the
    port brings every frame to the first non-empty file's CRS and scores
    1.0, as in the block's own order."""
    _, cfg = workspace
    fm = copy.deepcopy(cfg["final_metrics.py"])
    fm["inputs"]["to_evaluate"] = dict(sorted(
        fm["inputs"]["to_evaluate"].items()))
    assert next(iter(fm["inputs"]["to_evaluate"])) == "oth"

    def f1b(which):
        gm = pd.read_csv(tmp_path / which / "outputs" / "final" / "tables"
                         / "global metrics.csv")
        return {d: f for d, f in zip(gm["dataset"], gm["f1b"])
                if d != "baseline"}

    _run_in_copy(workspace, tmp_path / "ref", lambda: jevaluate.run(fm))
    _run_in_copy(workspace, tmp_path / "port", lambda: tevaluate.run(fm))
    _run_in_copy(workspace, tmp_path / "yaml", lambda: tevaluate.run(
        cfg["final_metrics.py"]))
    port, ref = f1b("port"), f1b("ref")
    assert port == f1b("yaml")
    for d in ("trn", "val", "all datasets"):
        assert port[d] == pytest.approx(1.0) and ref[d] == 0.0, (port, ref)


# ---------------------------------------------------------------------------
# 3. the quarries' 5 m buffer against the distance oracle

QUARRY_BUFFER = 5.0


def _quarries():
    """Seeded random quarries, shells and holes (test_torch_geom's random
    pairs' first polygons; those near the origin scaled to tens of
    metres)."""
    out = []
    for (s, h), _ in random_pairs(40, seed=52):
        s = np.asarray(s, float)
        k = 1.0 if abs(s.min(0)[0]) > 1e5 else 5.0
        out.append((s * k, [np.asarray(r, float) * k for r in h]))
    return out


def _buffer_misses(g, poly, d, pts) -> int:
    """Sampled points on the wrong side of the buffer ``g`` of ``poly`` by
    ``d`` (the distance oracle): points within d·cos(pi/32) of ``poly`` (or
    inside it) must be inside ``g``, points beyond d outside; the band
    between, where the buffer's 32-gon arcs lie, is not judged. A hole of
    ``g`` within d of ``poly`` (too small to be sampled) counts too."""
    inner = _within(pts, poly, d * np.cos(np.pi / 32) - 1e-6)
    outer = _within(pts, poly, d + 1e-6)
    inside = tn.points_in_polyset(pts, g._flat()) if not g.is_empty \
        else np.zeros(len(pts), bool)
    holes = [h for p in (g.geoms if g.geom_type == "MultiPolygon" else [g])
             for h in p.interiors_coords]
    return int((inner & ~inside).sum() + (~outer & inside).sum()) + sum(
        bool(_within(h.mean(0)[None], poly, d)[0]) for h in holes)


def _roads_around(rng, shell, n=12):
    """Small road rectangles near a quarry: inside it, across its border
    and within and beyond 5 m of it."""
    lo, hi = shell.min(0) - 12, shell.max(0) + 12
    roads = []
    for _ in range(n):
        c = rng.uniform(lo, hi)
        w, h = rng.uniform(0.5, 4.0, 2)
        roads.append([(c[0], c[1]), (c[0] + w, c[1]), (c[0] + w, c[1] + h),
                      (c[0], c[1] + h)])
    return roads


def test_quarry_buffers_against_the_distance_oracle():
    """Every 5 m buffer of the port agrees with the oracle; the
    reference's is wrong on many of these quarries (the T-junction fault
    the port repaired, ROADMAP Queue C), and where both agree with the
    oracle they are mostly equal. Where the two buffers are equal, both
    packages find the same roads in the quarry."""
    rng = np.random.default_rng(53)
    ref_wrong = equal = 0
    for i, (s, h) in enumerate(_quarries()):
        poly = tcore.Polygon(s, h)
        want = jcore.Polygon(s, h).buffer(QUARRY_BUFFER)
        got = poly.buffer(QUARRY_BUFFER)
        lo = np.array(poly.bounds[:2]) - QUARRY_BUFFER - 1
        hi = np.array(poly.bounds[2:]) + QUARRY_BUFFER + 1
        pts = rng.uniform(lo, hi, (20000, 2))
        assert _buffer_misses(got, poly, QUARRY_BUFFER, pts) == 0, i
        ref_wrong += _buffer_misses(want, poly, QUARRY_BUFFER, pts) > 0
        if geom_key(got) != geom_key(want):
            continue
        equal += 1
        roads = _roads_around(rng, s)
        jroads = JFrame({"OBJECTID": list(range(len(roads))),
                         "geometry": [jcore.Polygon(r) for r in roads]},
                        crs="EPSG:2056")
        troads = TFrame({"OBJECTID": list(range(len(roads))),
                         "geometry": [tcore.Polygon(r) for r in roads]},
                        crs="EPSG:2056")
        jin, jout = jclassify.get_roads_in_quarries(
            JFrame({"geometry": [jcore.Polygon(s, h)]}, crs="EPSG:2056"),
            jroads)
        tin, tout = tclassify.get_roads_in_quarries(
            TFrame({"geometry": [poly]}, crs="EPSG:2056"), troads)
        assert list(tin["OBJECTID"]) == list(jin["OBJECTID"]), i
        assert list(tout["OBJECTID"]) == list(jout["OBJECTID"]), i
    # measured on these 40 quarries: the reference's buffer is wrong on 19,
    # the port's on none; 19 of the 21 others are equal bit for bit
    assert ref_wrong >= 15 and equal >= 15, (ref_wrong, equal)
