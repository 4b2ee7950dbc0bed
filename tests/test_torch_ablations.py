"""The port's ablation and measurement tools (``roadsurf_tpu_torch/tools/
{ablate_seeded,ablate_mask_bits,ablate_fast_profile,measure_detections}
.py``) against the reference's scripts of the same names, on the CPU.

1. The calls are the scripts': each script's ``main`` and the port's run
   in a temporary directory with the scene, training, make_detections,
   final_metrics, ``latest_checkpoint`` (and for ``measure_detections``
   the calibration and ``detect_tiles``) replaced by recorders, and a
   ``global metrics.csv`` whose F1 moves from call to call. The recorded
   lists are equal: variant names and order, every model config field for
   field, each training's config, steps, batch, size, instances and seed,
   each detection's checkpoint, batch and mask format, the selection of
   ``ablate_fast_profile``'s double filter, the calibration tiles and
   ``detect_tiles``' arguments; and so are the JSON files the two write.
2. ``measure_detections`` end to end: narrow heads at 64 px on 8 tiles of
   the cut scene, weights saved by the reference's ``save_params`` and
   read by both packages; the port's records against the reference's
   ``detect_tiles`` records within the host stage's tolerances
   (``tests/test_torch_port_detections.py``: the same detections, scores
   within 1e-6, each detection's area within 2%), the
   records at ``scan_k`` 2 equal to those at 1, the script's JSON keys.
3. A tool asked for the card without one raises before it writes.

The cut runs (``ablate_seeded`` and ``ablate_mask_bits`` at
``quality.CUT``'s sizes) are ``test_torch_ablations_seeded.py`` and
``test_torch_ablations_mask.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import json
import os
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import roadsurf_tpu.models as j_models
import roadsurf_tpu.models.quant as j_quant
import roadsurf_tpu.pipeline.detections as j_det
import roadsurf_tpu.pipeline.evaluate as j_eval
import roadsurf_tpu.pipeline.training as j_train
import roadsurf_tpu.utils.checkpoint as j_ckpt
import roadsurf_tpu_torch.pipeline.detections as t_det
import roadsurf_tpu_torch.pipeline.evaluate as t_eval
import roadsurf_tpu_torch.pipeline.training as t_train
from roadsurf_tpu.models import init_params as j_init_params
from roadsurf_tpu.utils.checkpoint import save_params as j_save_params
from roadsurf_tpu_torch.models import fast_profile
from roadsurf_tpu_torch.tools import (ablate_fast_profile, ablate_mask_bits,
                                      ablate_seeded, measure_detections,
                                      quality)
from test_torch_port_model import narrow_cfg as j_narrow_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
SIDE = 64                       # the narrow forward's input side


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The cut scene (``quality.CUT``'s 4 x 4 grid): its training tiles."""
    from roadsurf_tpu_torch.utils.config import load_config

    root = tmp_path_factory.mktemp("scene")
    cfg = load_config(quality.CONFIG)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ablate_seeded.build_scene(cfg, quality.CUT["n_grid"])
    finally:
        os.chdir(cwd)
    images = root / quality.OD / "trn-images"
    assert len(list(images.glob("*.tif"))) >= 8
    return images


# ---------------------------------------------------------------------------
# 1. the calls are the scripts'

def _cfg(c) -> dict:
    return dataclasses.asdict(c)


class Calls:
    """Recorders in place of the stages: each appends (stage, arguments)
    with its defaults applied; final_metrics writes a global metrics
    table whose "all datasets" F1 rises by 0.01 a call."""

    def __init__(self):
        self.log: list = []
        self.n_eval = 0

    def train(self, real):
        sig = inspect.signature(real)

        def train(*a, **kw):
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            args = dict(b.arguments)
            self.log.append(("train", _cfg(args.pop("cfg")), {
                k: args[k] for k in (
                    "trn_coco", "trn_images", "log_dir", "max_iter",
                    "batch_size", "image_size", "max_instances",
                    "log_every", "seed")}))
        return train

    def detections(self, real):
        sig = inspect.signature(real)

        def run(*a, **kw):
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            args = dict(b.arguments)
            det = dict(args["cfg"])
            self.log.append(("detections", _cfg(args["model_cfg"]), {
                "cfg": det, "batch_size": args["batch_size"],
                "mask_format": args["mask_format"]}))
            return []
        return run

    def evaluate(self, block):
        self.log.append(("evaluate", block))
        self.n_eval += 1
        d = os.path.join(block["final_folder"], "tables")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "global metrics.csv"), "w") as f:
            f.write("dataset,f1b,Pb,Rb\n"
                    f"all datasets,{0.5 + 0.01 * self.n_eval:.4f},0.5,0.5\n"
                    "baseline,0.4,0.4,0.4\n")


def _latest(missing: str = ""):
    """A ``latest_checkpoint``: step 599 in every log dir but those whose
    name holds ``missing``, which have none."""
    def latest(log_dir, prefix="model_"):
        if missing and missing in log_dir:
            return None
        return os.path.join(log_dir, f"{prefix}0000599.npz")
    return latest


def _patch_reference(monkeypatch, calls: Calls, missing: str = ""):
    monkeypatch.setattr(j_train, "train", calls.train(j_train.train))
    monkeypatch.setattr(j_det, "run", calls.detections(j_det.run))
    monkeypatch.setattr(j_eval, "run", calls.evaluate)
    monkeypatch.setattr(j_ckpt, "latest_checkpoint", _latest(missing))


def _patch_port(monkeypatch, calls: Calls, missing: str = ""):
    monkeypatch.setattr(t_train, "train", calls.train(t_train.train))
    monkeypatch.setattr(t_det, "run", calls.detections(t_det.run))
    monkeypatch.setattr(t_eval, "run", calls.evaluate)
    for mod in (ablate_seeded, ablate_mask_bits, ablate_fast_profile):
        monkeypatch.setattr(mod, "latest_checkpoint", _latest(missing))


def _same_calls(ref: list, got: list):
    """Equal stage by stage; a port config holds every field of the
    reference's with the same value."""
    assert [c[0] for c in got] == [c[0] for c in ref]
    for r, g in zip(ref, got):
        if r[0] in ("scene", "evaluate"):
            assert g == r
            continue
        assert set(r[1]) <= set(g[1])
        assert {k: g[1][k] for k in r[1]} == r[1], r[0]
        assert g[2] == r[2], r[0]


def _run_reference(monkeypatch, tmp_path, name: str, argv: list,
                   calls: Calls, missing: str = ""):
    mod = _script(name)
    if hasattr(mod, "build_scene"):
        monkeypatch.setattr(mod, "build_scene",
                            lambda wd, cfg: calls.log.append(("scene",)))
    _patch_reference(monkeypatch, calls, missing)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    monkeypatch.chdir(tmp_path)
    mod.main()
    os.chdir(tmp_path)


def test_ablate_seeded_calls_are_the_scripts(tmp_path, monkeypatch):
    """Two seeds, every variant: the training calls, the 22 detection
    calls, and the written summaries."""
    ref_wd, port_wd = tmp_path / "ref", tmp_path / "port"
    ref, port = Calls(), Calls()
    _run_reference(monkeypatch, tmp_path, "ablate_seeded",
                   ["--seeds", "2", "--workdir", str(ref_wd)], ref)
    _patch_port(monkeypatch, port)
    monkeypatch.setattr(ablate_seeded, "build_scene",
                        lambda cfg, n_grid: port.log.append(("scene",)))
    assert ablate_seeded.main(["--seeds", "2", "--workdir", str(port_wd),
                               "--device", "cpu"]) == 0
    _same_calls(ref.log, port.log)
    trains = [c for c in port.log if c[0] == "train"]
    assert [c[2]["seed"] for c in trains] == [1000, 1001]
    assert {c[2]["image_size"] for c in trains} == {256}
    # the script's training config is quality_config(iters)
    want = _cfg(quality.quality_config(600))
    assert all({k: want[k] for k in c[1]} == c[1] for c in trains)
    dets = [c for c in port.log if c[0] == "detections"]
    assert len(dets) == 22
    assert [c[2]["cfg"]["model_weights"]["pth_file"] for c in dets[:2]] \
        == [f"logs_seed{s}/model_0000599.npz" for s in (0, 1)]
    names = list(ablate_seeded.VARIANTS)
    assert len(names) == 11
    assert [c[1] for c in dets[::2]] == [
        _cfg(ablate_seeded.VARIANTS[n]) for n in names]
    with open(ref_wd / "ablate_seeded.json") as f:
        want = json.load(f)
    with open(port_wd / "ablate_seeded.json") as f:
        got = json.load(f)
    assert got["summary"] == want["summary"]
    assert (got["seeds"], got["iters"]) == (want["seeds"], want["iters"])
    assert set(got) == set(want)


def test_ablate_seeded_filters_variants_as_the_script(tmp_path, monkeypatch):
    keep = "fast-R64,parity800+int8pyr,no-such-variant"
    ref, port = Calls(), Calls()
    _run_reference(monkeypatch, tmp_path, "ablate_seeded",
                   ["--seeds", "1", "--iters", "4", "--variants", keep,
                    "--workdir", str(tmp_path / "ref")], ref)
    _patch_port(monkeypatch, port)
    monkeypatch.setattr(ablate_seeded, "build_scene",
                        lambda cfg, n_grid: port.log.append(("scene",)))
    ablate_seeded.run(str(tmp_path / "port"), seeds=1, iters=4,
                      variants=keep, device="cpu")
    _same_calls(ref.log, port.log)
    assert [c[1]["int8_pyramid"] for c in port.log
            if c[0] == "detections"] == [False, True]
    assert [c[1]["checkpoint_period"] for c in port.log
            if c[0] == "train"] == [2]


def test_ablate_mask_bits_calls_are_the_scripts(tmp_path, monkeypatch):
    """Three seeds, seed 1 without a checkpoint: skipped by both; u8 then
    bits for seeds 0 and 2; the same JSON written."""
    for wd in ("ref", "port"):
        (tmp_path / wd).mkdir()
    ref, port = Calls(), Calls()
    _run_reference(monkeypatch, tmp_path, "ablate_mask_bits",
                   ["--seeds", "3", "--workdir", str(tmp_path / "ref")], ref,
                   missing="seed1")
    _patch_port(monkeypatch, port, missing="seed1")
    assert ablate_mask_bits.main(["--seeds", "3", "--workdir",
                                  str(tmp_path / "port"), "--device",
                                  "cpu"]) == 0
    _same_calls(ref.log, port.log)
    dets = [c for c in port.log if c[0] == "detections"]
    assert [(c[2]["cfg"]["model_weights"]["pth_file"], c[2]["mask_format"])
            for c in dets] == [
        ("logs_seed0/model_0000599.npz", "u8"),
        ("logs_seed0/model_0000599.npz", "bits"),
        ("logs_seed2/model_0000599.npz", "u8"),
        ("logs_seed2/model_0000599.npz", "bits")]
    assert {c[2]["batch_size"] for c in dets} == {16}
    with open(tmp_path / "ref" / "ablate_mask_bits.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "ablate_mask_bits.json") as f:
        got = json.load(f)
    assert got == want
    assert got["delta_bits_minus_u8"] == [0.01, 0.01]


@pytest.mark.parametrize("keep", ["", "D16,R32+int8",
                                  "exactnms,int8,no-such-variant"])
def test_ablate_fast_profile_selects_as_the_script(tmp_path, monkeypatch,
                                                    capsys, keep):
    """The double filter: a table variant and a late one, or every one."""
    for wd in ("ref", "port"):
        (tmp_path / wd).mkdir()
    ref, port = Calls(), Calls()
    _run_reference(monkeypatch, tmp_path, "ablate_fast_profile",
                   ["--workdir", str(tmp_path / "ref"), "--variants", keep],
                   ref)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _patch_port(monkeypatch, port)
    assert ablate_fast_profile.main(["--workdir", str(tmp_path / "port"),
                                     "--variants", keep, "--device",
                                     "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _same_calls(ref.log, port.log)
    assert list(got) == list(want) == list(ablate_fast_profile.selection(
        keep))
    assert got == want
    assert len(want) == {"": 16}.get(keep, 2)


def _write_tiles(d: Path, n: int, seed: int = 0) -> Path:
    from roadsurf_tpu_torch.io.geotiff import write_geotiff

    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_geotiff(str(d / f"t{i:02d}.tif"),
                      rng.integers(0, 255, (256, 256, 3), np.uint8),
                      (0.0, 0.0, 256.0, 256.0))
    return d


@pytest.mark.parametrize("int8", [False, True])
def test_measure_detections_calls_are_the_scripts(tmp_path, monkeypatch,
                                                  capsys, int8):
    """20 tiles cycled from 5, batches of 8: the warm-up and the timed
    ``detect_tiles`` calls (configs, tile names, bounds, batch, scan_k,
    mask format), and with ``--int8`` the 8 calibration tiles; the JSON
    line's keys."""
    images = _write_tiles(tmp_path / "images", 5)
    jcfg, tcfg = j_narrow_cfg(SIDE), _narrow_port_cfg()
    seen = {"ref": [], "port": []}

    def recorder(side):
        def detect_tiles(params, cfg, paths, bounds, **kw):
            seen[side].append(("detect_tiles", _cfg(cfg),
                               [os.path.basename(p) for p in paths],
                               [tuple(b) for b in bounds], kw))
            return []

        def prepare(params, images, cfg, *a, **kw):
            seen[side].append(("calibrate", _cfg(cfg), images.copy()))
            return {}
        return detect_tiles, prepare

    det, prep = recorder("ref")
    monkeypatch.setattr(j_det, "detect_tiles", det)
    monkeypatch.setattr(j_quant, "prepare_quantized", prep)
    monkeypatch.setattr(j_models, "fast_profile", lambda: jcfg)
    argv = ["--images", str(images), "--n-tiles", "20", "--batch", "8",
            "--scan-k", "2", "--mask-format", "u8"] + (
        ["--int8"] if int8 else [])
    monkeypatch.setattr(sys, "argv", ["measure_detections.py", *argv])
    _script("measure_detections").main()
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    det, prep = recorder("port")
    monkeypatch.setattr(t_det, "detect_tiles", det)
    monkeypatch.setattr(measure_detections, "prepare_quantized", prep)
    got_line = measure_detections.run(
        str(images), n_tiles=20, batch=8, int8=int8, scan_k=2,
        mask_format="u8", device="cpu", cfg=tcfg)
    assert set(want_line) <= set(got_line)
    ref, got = seen["ref"], seen["port"]
    assert [c[0] for c in got] == [c[0] for c in ref] == (
        ["calibrate"] if int8 else []) + ["detect_tiles"] * 2
    for r, g in zip(ref, got):
        assert {k: g[1][k] for k in r[1]} == r[1]
        if r[0] == "calibrate":
            np.testing.assert_array_equal(g[2], r[2])
            assert g[2].shape == (8, 256, 256, 3)
            continue
        assert g[2:4] == r[2:4]
        assert {k: g[4][k] for k in r[4]} == r[4]
    assert got[-1][2] == [f"{i:05d}.tif" for i in range(20)]
    assert len(got[-2][2]) == 8
    assert got[-1][1]["int8_pyramid"] is int8


def test_measure_detections_from_scratch_scales_as_the_training_did(
        tmp_path, monkeypatch):
    """``from_scratch`` (the port's addition): the fast profile with the
    from-scratch trainings' input scaling (``quality_config``'s), nothing
    else changed; without it, the script's unit std."""
    images = _write_tiles(tmp_path / "images", 2)
    seen = []
    monkeypatch.setattr(t_det, "detect_tiles",
                        lambda state, cfg, *a, **kw: seen.append(cfg) or [])
    for flag in (False, True):
        line = measure_detections.run(str(images), n_tiles=2, batch=2,
                                      device="cpu", from_scratch=flag)
        assert line["from_scratch"] is flag
    plain, scratch = _cfg(seen[-3]), _cfg(seen[-1])
    assert plain == _cfg(fast_profile())
    assert scratch["pixel_std"] == quality.quality_config(1).pixel_std \
        != plain["pixel_std"]
    assert {k for k in plain if plain[k] != scratch[k]} == {"pixel_std"}


# ---------------------------------------------------------------------------
# 2. measure_detections end to end

def _narrow_port_cfg():
    return replace(fast_profile(post_nms_topk=32), fpn_channels=32,
                   box_fc_dim=64, mask_conv_dim=32, min_size_test=SIDE,
                   max_size_test=SIDE, compute_dtype="float32")


def _groups(records: list) -> dict:
    """{(det_class, score): total polygon area} of a record list."""
    out: dict = {}
    for r in records:
        k = (int(r["det_class"]), float(r["score"]))
        out[k] = out.get(k, 0.0) + r["geometry"].area
    return out


def test_measure_detections_gives_the_references_records(
        scene, tmp_path, monkeypatch, capsys):
    """8 of the cut scene's tiles at B=4, narrow heads at 64 px. The
    weights: the reference's ``init_params`` with the residual branches'
    last scales made non-zero (as ``tests/test_torch_port_detections.py``'s
    end-to-end test has them) and
    the mask predictor's bias at +3, so that each mask fills its box
    (untrained masks sit at 0.5 everywhere and trace into hundreds of
    slivers a tile, seconds of host time each on this CPU); saved by the
    reference's ``save_params``."""
    images = tmp_path / "images"
    images.mkdir()
    for p in sorted(scene.glob("*.tif"))[:8]:
        os.link(p, images / p.name)
    jcfg = j_narrow_cfg(SIDE)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    for stage in ("res2", "res3", "res4", "res5"):
        for bp in tree["backbone"][stage]:
            sc = bp["conv3"]["scale"]
            bp["conv3"]["scale"] = rng.uniform(0.05, 0.1, sc.shape).astype(
                np.float32)
    tree["mask_head"]["predictor"]["b"] = np.full_like(
        tree["mask_head"]["predictor"]["b"], 3.0)
    ckpt = str(tmp_path / "logs" / "model_0000599.npz")
    j_save_params(ckpt, tree)

    calls = []

    def spy(*a, _real=j_det.detect_tiles, **kw):
        out = _real(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(j_det, "detect_tiles", spy)
    monkeypatch.setattr(j_models, "fast_profile", lambda: jcfg)
    monkeypatch.setattr(sys, "argv", [
        "measure_detections.py", "--images", str(images), "--ckpt",
        str(tmp_path / "logs"), "--n-tiles", "8", "--batch", "4"])
    _script("measure_detections").main()
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = calls[-1]

    got, got_k2 = [], []
    line = measure_detections.run(str(images), str(tmp_path / "logs"),
                                  n_tiles=8, batch=4, device="cpu",
                                  cfg=_narrow_port_cfg(), records=got)
    measure_detections.run(str(images), ckpt, n_tiles=8, batch=4, scan_k=2,
                           device="cpu", cfg=_narrow_port_cfg(),
                           records=got_k2)
    assert set(want_line) <= set(line)
    assert line["records"] == len(got) == want_line["records"] == len(ref)
    assert line["stages"]["detections"] > 0
    want_g, got_g = _groups(ref), _groups(got)
    assert len(want_g) > 8
    wk, gk = sorted(want_g), sorted(got_g)
    assert [k[0] for k in gk] == [k[0] for k in wk]
    for a, b in zip(gk, wk):
        assert abs(a[1] - b[1]) <= 1e-6, (a, b)
        assert abs(got_g[a] - want_g[b]) <= 0.02 * want_g[b], (a, b)

    from roadsurf_tpu_torch.io import wkb

    def keys(recs):
        return [(wkb.dumps(r["geometry"]), r["score"], r["det_class"])
                for r in recs]
    assert keys(got_k2) == keys(got)


# ---------------------------------------------------------------------------
# 3. the card

def test_the_tools_raise_without_a_card_before_they_write(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    images = _write_tiles(tmp_path / "images", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_detections.main(["--images", str(images), "--n-tiles",
                                 "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ablate_seeded.run(str(tmp_path / "seeded"), seeds=1, iters=1,
                          cut=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ablate_mask_bits.main(["--workdir", str(images), "--seeds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ablate_fast_profile.main(["--workdir", str(images)])
    assert sorted(os.listdir(tmp_path)) == ["images"]
    assert os.listdir(images) == ["t00.tif"]
