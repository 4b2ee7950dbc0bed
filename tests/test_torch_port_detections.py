"""The port's make_detections host stage and checkpoint loading against the
JAX package's, on the CPU.

* From identical detections (one stub engine in place of both packages'
  ``TileInferenceEngine``): the records, WKB bytes, score and det_class in
  order, are equal, and so is every row of the two GeoPackages apart from
  ``gpkg_contents.last_change``; the empty dataset too (srs 3857, the
  columns typed alike). Tolerance: none; the two host stages run the same arithmetic.
* ``.pth``: the port's ``load_params`` gives the reference converter's tree
  leaf for leaf, and ``merge_params`` skips the same class-count heads.
* The int8 branch calibrates on the reference's tiles.
* The whole pipeline, each package's own forward: the same detections
  (tile, det_class, score within 1e-6), each detection's polygons' total
  area within 2% and their envelope within one pixel, the same gpkg schema.
  The forwards agree to 1e-4 px on boxes (tests/test_torch_port_model.py),
  and a box moved that far can flip a pasted pixel whose bilinear value
  lies at 0.5, which moves a ring and so its RDP simplification.
"""

import json
import math
import os
import sqlite3
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

import roadsurf_tpu.engine.infer as j_infer
import roadsurf_tpu.models.quant as j_quant
import roadsurf_tpu.pipeline.detections as jdet
import roadsurf_tpu_torch.engine.infer as t_infer
import roadsurf_tpu_torch.models.quant as t_quant
import roadsurf_tpu_torch.pipeline.detections as tdet
from roadsurf_tpu.io import write_file as j_write_file
from roadsurf_tpu.io import wkb as jwkb
from roadsurf_tpu.models import fast_profile as j_fast_profile
from roadsurf_tpu.models import init_params as j_init_params
from roadsurf_tpu.utils.checkpoint import save_params as j_save_params
from roadsurf_tpu.utils.d2_convert import load_detectron2_checkpoint
from roadsurf_tpu.utils.d2_convert import merge_params as j_merge_params
from roadsurf_tpu_torch.io import geotiff as ttif
from roadsurf_tpu_torch.io import wkb as twkb
from roadsurf_tpu_torch.io.gpkg import write_gpkg
from roadsurf_tpu_torch.models import fast_profile, init_params
from roadsurf_tpu_torch.utils.d2_convert import merge_params
from roadsurf_tpu_torch.utils.weights import from_jax_params, load_params
from test_torch_parity import _fake_d2_state_dict
from test_torch_port_model import narrow_cfg as j_narrow_cfg

torch.set_num_threads(1)

TILE = 64
ORIGIN = math.pi * 6378137.0


def _tile_bounds(x: int, y: int, z: int = 18):
    """(west, south, east, north) of tile z/x/y in EPSG:3857."""
    ts = 2.0 * ORIGIN / (1 << z)
    w, n = -ORIGIN + x * ts, ORIGIN - y * ts
    return (w, n - ts, w + ts, n)


def _write_dataset(wd, n: int, ds: str = "tst", seed: int = 0):
    """n synthetic zoom-18 GeoTIFF tiles of TILE px in ``wd/{ds}-images``,
    the COCO list and the image metadata; returns (coco, meta, images dir,
    the tiles' bounds)."""
    img_dir = os.path.join(wd, f"{ds}-images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    coco, meta, bounds = {"images": []}, {}, []
    for i in range(n):
        x, y = 137150 + i % 4, 92343 + i // 4
        fn = f"18_{x}_{y}.tif"
        b = _tile_bounds(x, y)
        ttif.write_geotiff(os.path.join(img_dir, fn),
                           rng.integers(0, 255, (TILE, TILE, 3), np.uint8), b)
        coco["images"].append({"id": i, "file_name": fn, "width": TILE,
                               "height": TILE})
        meta[fn] = {"bounds_3857": list(b)}
        bounds.append(b)
    with open(os.path.join(wd, f"COCO_{ds}.json"), "w") as f:
        json.dump(coco, f)
    with open(os.path.join(wd, "img_metadata.json"), "w") as f:
        json.dump(meta, f)
    return coco, meta, img_dir, bounds


# ---------------------------------------------------------------------------
# identical detections through both host stages

def _blob_masks(rng, k: int) -> np.ndarray:
    """k 28x28 masks: smooth blobs with holes and islands, and pure noise."""
    yy, xx = np.mgrid[0:28, 0:28]
    out = []
    for i in range(k):
        if i % 3 == 2:
            out.append(rng.random((28, 28)) > 0.5)
            continue
        f = np.zeros((28, 28))
        for _ in range(3):
            c = rng.uniform(0, 28, 2)
            f += np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2)
                        / rng.uniform(10, 60))
        out.append((f > 0.4) & ~((f > 0.9) & (f < 1.1)))
    return np.asarray(out)


def _synthetic_dets(n: int, mask_key: str, D: int = 6, seed: int = 3
                    ) -> dict:
    """The engine's output for n tiles, masks in ``mask_key``'s format:
    scores around the 0.05 threshold, boxes past the tile's edges, tile 3
    without a valid detection."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, TILE - 8, (n, D, 2))
    wh = rng.uniform(3, 40, (n, D, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0.2, 0.99, (n, D)).astype(np.float32)
    scores[:, :3] = np.float32([0.05, np.nextafter(np.float32(0.05),
                                                   np.float32(0)), 0.0500001])
    valid = rng.random((n, D)) > 0.2
    valid[3 % n] = False
    probs = _blob_masks(rng, n * D).reshape(n, D, 28, 28)
    if mask_key == "mask_bits":
        masks = np.packbits(probs.reshape(n, D, 784), axis=-1,
                            bitorder="little")
    else:
        masks = np.where(probs, rng.integers(128, 256, probs.shape),
                         rng.integers(0, 128, probs.shape)).astype(np.uint8)
    return {"boxes": boxes, "scores": scores,
            "classes": rng.integers(0, 2, (n, D)).astype(np.int32),
            "valid": valid, mask_key: masks}


def _stub_engine(dets: dict, seen: list):
    """One engine class for both packages: yields ``dets``' rows for each
    batch of tiles it is given; records what it was constructed with."""
    class StubEngine:
        def __init__(self, params, cfg, batch_size=16, **kw):
            seen.append({"quant": params.get("quant"), "batch": batch_size})
            self.stats = {"h2d_s": 0.0, "d2h_s": 0.0}

        def run(self, it):
            i = 0
            for imgs in it:
                n = len(imgs)
                assert imgs.shape[1:] == (TILE, TILE, 3)
                yield {k: v[i:i + n].copy() for k, v in dets.items()}
                i += n
    return StubEngine


def _patch_engines(monkeypatch, dets, seen):
    eng = _stub_engine(dets, seen)
    monkeypatch.setattr(j_infer, "TileInferenceEngine", eng)
    monkeypatch.setattr(t_infer, "TileInferenceEngine", eng)


def _detect_both(tmp_path, n: int):
    """Both packages' detect_dataset over the same n GeoTIFF tiles."""
    coco, meta, img_dir, _ = _write_dataset(str(tmp_path), n)
    kw = dict(batch_size=2, score_thresh=0.05, rdp_eps=0.75, tile_size=TILE)
    j = jdet.detect_dataset({}, j_fast_profile(), coco, img_dir, meta, **kw)
    stats = {}
    t = tdet.detect_dataset({}, fast_profile(), coco, img_dir, meta,
                            device="cpu", stats=stats, **kw)
    return j, t, stats


def _assert_same_records(j, t):
    assert len(t) == len(j)
    jg = list(j["geometry"])
    for i in range(len(t)):
        assert twkb.dumps(t.geometry[i]) == jwkb.dumps(jg[i]), i
        assert t.score[i] == j["score"].iloc[i]
        assert t.det_class[i] == j["det_class"].iloc[i]
    assert t.score.dtype == np.float64 and t.det_class.dtype == np.int64


def _write_both(tmp_path, j, t, layer="tst_detections"):
    """Each package's run(): reproject a non-empty frame, write the gpkg."""
    pj, pt = str(tmp_path / "ref.gpkg"), str(tmp_path / "port.gpkg")
    j_write_file(j.to_crs(epsg=4326) if len(j) else j, pj, layer=layer)
    write_gpkg(t.to_crs(4326) if len(t) else t, pt, layer=layer)
    return pj, pt


def _gpkg_dump(path: str) -> dict:
    """Every table's rows (gpkg_contents without last_change), the schema
    and the GeoPackage pragmas."""
    con = sqlite3.connect(path)
    try:
        out = {"schema": con.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master "
            "ORDER BY name").fetchall(),
            "pragmas": (con.execute("PRAGMA application_id").fetchone(),
                        con.execute("PRAGMA user_version").fetchone())}
        for (name,) in con.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"):
            cols = [r[1] for r in con.execute(f'PRAGMA table_info("{name}")')
                    if r[1] != "last_change"]
            out[name] = con.execute(
                f'SELECT {", ".join(cols)} FROM "{name}"').fetchall()
        return out
    finally:
        con.close()


@pytest.mark.parametrize("mask_key", ["mask_bits", "mask_probs_u8"])
def test_host_stage_writes_the_reference_records_and_gpkg(
        tmp_path, monkeypatch, mask_key):
    n = 5                                   # batches of 2, 2 and a tail of 1
    dets = _synthetic_dets(n, mask_key)
    seen = []
    _patch_engines(monkeypatch, dets, seen)
    j, t, stats = _detect_both(tmp_path, n)
    assert len(seen) == 2 and len(t) > 0
    _assert_same_records(j, t)
    # the 0.05 threshold kept 0.05 and dropped the float32 just below it
    s32 = t.score.astype(np.float32)
    assert (s32 == np.float32(0.05)).any() and (s32 >= np.float32(0.05)).all()
    assert stats["tiles"] == n and stats["records"] == len(t)
    assert stats["detections"] == int((dets["valid"]
                                       & (dets["scores"] >= 0.05)).sum())
    pj, pt = _write_both(tmp_path, j, t)
    ref, got = _gpkg_dump(pj), _gpkg_dump(pt)
    assert got == ref
    assert got["gpkg_geometry_columns"] == [
        ("tst_detections", "geom", "POLYGON", 4326, 0, 0)]


def test_empty_dataset_writes_the_reference_gpkg(tmp_path, monkeypatch):
    """No valid detection at all: the 3857 frame is written un-reprojected
    by both, its columns typed alike (REAL: pandas 3 makes the reference's
    columns from empty lists float64)."""
    n = 3
    dets = _synthetic_dets(n, "mask_bits")
    dets["valid"][:] = False
    _patch_engines(monkeypatch, dets, [])
    j, t, _ = _detect_both(tmp_path, n)
    assert len(j) == len(t) == 0
    pj, pt = _write_both(tmp_path, j, t)
    ref, got = _gpkg_dump(pj), _gpkg_dump(pt)
    assert got == ref
    assert got["gpkg_geometry_columns"] == [
        ("tst_detections", "geom", "GEOMETRY", 3857, 0, 0)]
    sql = dict((r[1], r[3]) for r in got["schema"])["tst_detections"]
    assert '"score" REAL' in sql and '"det_class" REAL' in sql


# ---------------------------------------------------------------------------
# int8 calibration branch

@pytest.mark.parametrize("n", [5, 20])
def test_int8_branch_calibrates_on_the_reference_tiles(tmp_path, monkeypatch,
                                                       n):
    """At most 8 tiles spread by np.linspace, the same arrays; the port's
    state["quant"] is set before the engine is built; a state that has a
    quant tree is not calibrated again."""
    coco, meta, img_dir, _ = _write_dataset(str(tmp_path), n)
    dets = _synthetic_dets(n, "mask_bits")
    dets["valid"][:] = False
    seen, cals = [], {}
    _patch_engines(monkeypatch, dets, seen)

    def recorder(name):
        def prepare(params, images, cfg, *a, **kw):
            cals[name] = np.array(images)
            return {"calibrated_by": name}
        return prepare

    monkeypatch.setattr(j_quant, "prepare_quantized", recorder("ref"))
    monkeypatch.setattr(t_quant, "prepare_quantized", recorder("port"))
    kw = dict(batch_size=4, tile_size=TILE)
    jdet.detect_dataset({}, replace(j_fast_profile(), int8_scope="full"),
                        coco, img_dir, meta, **kw)
    tdet.detect_dataset({}, replace(fast_profile(), int8_scope="full"), coco,
                        img_dir, meta, device="cpu", **kw)
    assert cals["port"].shape == (min(n, 8), TILE, TILE, 3)
    np.testing.assert_array_equal(cals["port"], cals["ref"])
    assert [s["quant"] for s in seen] == [{"calibrated_by": "ref"},
                                          {"calibrated_by": "port"}]
    cals.clear()
    tdet.detect_dataset({"quant": {"given": 1}},
                        replace(fast_profile(), int8_scope="full"), coco,
                        img_dir, meta, device="cpu", **kw)
    assert not cals and seen[-1]["quant"] == {"given": 1}


# ---------------------------------------------------------------------------
# .pth checkpoints

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in _flat(sub, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v for i, sub in enumerate(tree)
                for k2, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def test_pth_checkpoint_loads_into_the_reference_converters_tree(tmp_path):
    sd = _fake_d2_state_dict()               # COCO-80 heads
    path = str(tmp_path / "model_0005999.pth")
    torch.save(sd, path)
    del sd
    tree, step = load_params(path)
    ref = load_detectron2_checkpoint(path)
    assert step is None
    got, want = _flat(tree), _flat(ref)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the 2-class model's init: both merges skip the same class-count heads
    init = init_params(fast_profile(), torch.Generator().manual_seed(0))
    init_np = {k: {kk: _np_tree(vv) for kk, vv in v.items()}
               for k, v in init.items()}
    merged, skipped = merge_params(init, tree)
    j_merged, j_skipped = j_merge_params(init_np, ref)
    assert skipped == j_skipped
    assert {"box_head/cls/w", "box_head/bbox/w",
            "mask_head/predictor/w"} <= set(skipped)
    got, want = _flat(merged), _flat(j_merged)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    from_jax_params(merged)                 # every leaf consumed


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return t.numpy()


# ---------------------------------------------------------------------------
# the whole pipeline, each package's own forward

def _run_cfg(wd: str) -> dict:
    from roadsurf_tpu_torch.utils.config import load_script_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_script_config(os.path.join(root, "config",
                                          "config_obj_detec.yaml"),
                             "make_detections.py")
    return dict(cfg, working_directory=wd)


def _records(path: str, layer: str, tiles4326) -> dict:
    """{(tile, det_class, score): [(area, envelope)]} of a gpkg's records;
    a record's tile is the one that holds its envelope's centre."""
    from roadsurf_tpu.io.gpkg import _parse_gpb
    con = sqlite3.connect(path)
    try:
        rows = con.execute(
            f'SELECT geom, score, det_class FROM "{layer}"').fetchall()
    finally:
        con.close()
    out = {}
    for blob, score, cls in rows:
        g = _parse_gpb(blob)
        x0, y0, x1, y1 = g.bounds
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        tile = [i for i, (w, s, e, n) in enumerate(tiles4326)
                if w <= cx <= e and s <= cy <= n]
        assert len(tile) == 1
        out.setdefault((tile[0], cls, score), []).append(
            (g.area, np.array(g.bounds)))
    return out


def test_run_matches_the_reference_pipeline_end_to_end(tmp_path,
                                                        monkeypatch):
    """5 tiles of 64 px, batches of 2, the reference's init_params (conv3
    scales made non-zero) saved as the .npz beside the pinned .pth name;
    each package's run() with its own forward."""
    jcfg = j_narrow_cfg(TILE)
    tcfg = replace(fast_profile(post_nms_topk=32), fpn_channels=32,
                   box_fc_dim=64, mask_conv_dim=32, min_size_test=TILE,
                   max_size_test=TILE, compute_dtype="float32")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    for stage in ("res2", "res3", "res4", "res5"):
        for bp in tree["backbone"][stage]:
            sc = bp["conv3"]["scale"]
            bp["conv3"]["scale"] = rng.uniform(0.05, 0.1, sc.shape).astype(
                np.float32)
    sides = {}
    for name, pkg in (("ref", jdet), ("port", tdet)):
        wd = str(tmp_path / name)
        _, _, _, bounds = _write_dataset(wd, 5)
        j_save_params(os.path.join(wd, "logs", "model_0005999.npz"), tree)
        skipped = []

        def merge(init, loaded, _orig=pkg.merge_params):
            merged, sk = _orig(init, loaded)
            skipped.append(sk)
            return merged, sk

        monkeypatch.setattr(pkg, "merge_params", merge)
        kw = {"device": "cpu"} if pkg is tdet else {}
        files = pkg.run(_run_cfg(wd), model_cfg=jcfg if pkg is jdet else tcfg,
                        batch_size=2, **kw)
        assert skipped == [[]], f"{name}: merge skipped {skipped}"
        assert [os.path.basename(f) for f in files] == [
            "tst_detections_at_0dot05_threshold.gpkg"]
        sides[name] = files[0]

    from roadsurf_tpu.crs import transform_xy
    tiles4326 = []
    for w, s, e, n in bounds:
        (x0, x1), (y0, y1) = transform_xy(3857, 4326, [w, e], [s, n])
        tiles4326.append((x0, y0, x1, y1))
    px = (tiles4326[0][2] - tiles4326[0][0]) / TILE
    ref = _records(sides["ref"], "tst_detections", tiles4326)
    got = _records(sides["port"], "tst_detections", tiles4326)
    assert len(ref) > 0
    ref_keys, got_keys = sorted(ref), sorted(got)
    assert [k[:2] for k in got_keys] == [k[:2] for k in ref_keys]
    for kg, kr in zip(got_keys, ref_keys):
        assert abs(kg[2] - kr[2]) <= 1e-6, (kg, kr)
        ag = sum(a for a, _ in got[kg])
        ar = sum(a for a, _ in ref[kr])
        assert abs(ag - ar) <= 0.02 * ar, (kg, ag, ar)
        eg = np.array([b for _, b in got[kg]])
        er = np.array([b for _, b in ref[kr]])
        env_g = np.r_[eg[:, :2].min(0), eg[:, 2:].max(0)]
        env_r = np.r_[er[:, :2].min(0), er[:, 2:].max(0)]
        assert np.abs(env_g - env_r).max() <= px, (kg, env_g, env_r)
    assert _gpkg_dump(sides["port"])["schema"] \
        == _gpkg_dump(sides["ref"])["schema"]
