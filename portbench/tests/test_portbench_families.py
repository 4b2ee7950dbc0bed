"""A configuration's model family (``families/<name>.py``): the default
``r50_fpn`` runs the very code the cells ran before families, and a family
added as files runs through ``harness.run_cell`` with no file of
``portbench/`` edited."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch
from conftest import narrow

from portbench import harness, modelgen, reference, spec, work

torch.set_num_threads(1)

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_a_configuration_without_the_key_is_r50_fpn():
    for name in CELLS:
        cell = spec.cell(name)
        assert "family" not in cell.config
        assert Path(cell.family.__file__) == \
            spec.HERE / "families" / f"{spec.DEFAULT_FAMILY}.py"
    fam = spec.family("r50_fpn")
    assert fam.weights is modelgen.weights
    assert fam.pin_classes is modelgen.pin_classes
    assert fam.PIN_TILES == modelgen.PIN_TILES
    assert fam.run is reference.run
    assert fam.forward_flops is work.forward_flops
    assert fam.pooler_bytes is work.pooler_bytes
    assert fam.nms_bytes is work.nms_bytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CELLS)
def test_r50_fpn_weights_are_modelgen_weights(name, dtype):
    """Leaf for leaf, bit for bit, from one seed, narrow."""
    cell = spec.cell(name)
    st = dict(cell.config["settings"], **narrow(cell)["settings"])
    seed = 2 ** 31 + 11
    got = cell.family.weights(st, modelgen.generator(seed, "cpu"), "cpu",
                              dtype)
    want = modelgen.weights(st, modelgen.generator(seed, "cpu"), "cpu",
                            dtype)
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == dtype, path
        assert a.stride() == b.stride(), path
        assert torch.equal(a.view(BITS[dtype]), b.view(BITS[dtype])), path


@pytest.mark.parametrize("name", CELLS)
def test_r50_fpn_counts_are_work_counts(name):
    """At the published shapes; ``ctx.work`` gives them beside the peaks."""
    cell = spec.cell(name)
    st = cell.config["settings"]
    counts = harness.Work(cell.family)
    assert counts.forward_flops(st, 256) == work.forward_flops(st, 256)
    for precision in ("bfloat16", "float32"):
        assert counts.pooler_bytes(st, precision) == \
            work.pooler_bytes(st, precision)
    assert counts.nms_bytes(st) == work.nms_bytes(st)
    assert counts.BF16_PEAK == work.BF16_PEAK == 989e12
    assert counts.HBM_BYTES_PER_S == work.HBM_BYTES_PER_S == 3.35e12
    gflop = {"parity-800": 366.09, "fast-256": 33.09}[cell.config["name"]]
    assert counts.forward_flops(st, 256) / 1e9 == pytest.approx(gflop,
                                                                abs=0.01)


def _tree(tmp_path: Path) -> Path:
    """A copy of the benchmark's data and modules that files can be added
    to."""
    for d in ("configs", "traffic", "metrics", "families"):
        shutil.copytree(spec.HERE / d, tmp_path / d)
    return tmp_path


def _dry(cell, seed):
    """One dispatch (a 0 s window) of ``cell``, narrow; every returned
    tile checked."""
    ov = narrow(cell)
    ov["traffic"]["check_tiles"] = 256
    res = harness.run_cell(cell, seed, 0.0, False, time.perf_counter(),
                           device="cpu", overrides=ov)
    res["readings"].pop("check_s")
    return res


@pytest.mark.parametrize("name", CELLS)
def test_the_key_written_out_reads_the_same(name, tmp_path, monkeypatch):
    """``run_cell``'s readings with the key absent and with ``"family":
    "r50_fpn"`` in the configuration's file."""
    absent = spec.cell(name)
    cfg = BENCH["workloads"][CELLS.index(name)]["config"]
    path = _tree(tmp_path) / "configs" / f"{cfg}.json"
    d = json.loads(path.read_text())
    path.write_text(json.dumps(dict(d, family="r50_fpn")))
    monkeypatch.setattr(spec, "HERE", tmp_path)
    written = spec.cell(name)
    assert written.config["family"] == "r50_fpn"
    assert Path(written.family.__file__) == \
        tmp_path / "families" / "r50_fpn.py"
    a, b = _dry(absent, 2 ** 31 + 5), _dry(written, 2 ** 31 + 5)
    assert a["correct"] and a["readings"]["detections_program"] > 0
    assert a["readings"] == b["readings"]
    assert (a["attempted"], a["failed"]) == (b["attempted"], b["failed"])


PROBE = '''"""A family for the test: R50-FPN's functions, each call recorded, at
narrower widths, and a forward count of its own."""

from portbench import modelgen, reference, work

CALLS = []
PIN_TILES = 2
NARROW = {"stem_out": 8, "res2_out": 16, "fpn_channels": 8,
          "box_fc_dim": 16, "mask_conv_dim": 8}
pooler_bytes, nms_bytes = work.pooler_bytes, work.nms_bytes


def weights(st, g, device, dtype):
    CALLS.append(("weights", st["res2_out"]))
    return modelgen.weights(st, g, device, dtype)


def pin_classes(state, st, tiles_u8, device):
    CALLS.append(("pin_classes", len(tiles_u8)))
    modelgen.pin_classes(state, st, tiles_u8, device)


def run(W, images_u8, st, given=None, block=8):
    CALLS.append(("run", len(images_u8)))
    return reference.run(W, images_u8, st, given, block)


def forward_flops(st, tile_px):
    return 7 * work.forward_flops(st, tile_px)
'''

GFLOP = '''def read(ctx):
    return ctx.work.forward_flops(ctx.settings, ctx.tile_px) / 1e9
'''


def _snapshot(root: Path) -> dict:
    return {p: p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts
            and ".cache" not in p.parts}


def test_a_family_is_a_file(tmp_path, monkeypatch):
    """A family module, a configuration that names it, a metric that
    reads its count and their BENCHMARK.json entries, added as files: the
    cell runs through ``run_cell`` on the new family's functions."""
    before = _snapshot(spec.HERE)
    root = _tree(tmp_path)
    (root / "families" / "probe.py").write_text(PROBE)
    (root / "metrics" / "probe.gflop.py").write_text(GFLOP)
    cfg = json.loads((root / "configs" / "fast-256.json").read_text())
    (root / "configs" / "probe-256.json").write_text(
        json.dumps(dict(cfg, family="probe")))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][1], name="probe-256",
                                 file="portbench/configs/probe-256.json"))
    bench["workloads"].append({"name": "probe-256.detect-b16",
                               "config": "probe-256",
                               "traffic": "detect-b16", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "probe.gflop", "unit": "GFLOP",
                                "better": "lower", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["probe-256.detect-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", root)
    cell = spec.cell("probe-256.detect-b16",
                     spec.benchmark(root / "BENCHMARK.json"))
    fam = cell.family
    assert Path(fam.__file__) == root / "families" / "probe.py"
    ov = narrow(cell)
    assert ov["settings"]["res2_out"] == 16
    res = harness.run_cell(cell, 2 ** 31 + 9, 0.3, False,
                           time.perf_counter(), device="cpu", overrides=ov)
    assert res["correct"], res["checks"]
    assert res["readings"]["detections_program"] > 0
    assert fam.CALLS[:2] == [("weights", 16), ("pin_classes", 2)]
    assert fam.CALLS[2:] == [("run", res["readings"]["tiles"])]
    st = dict(cfg["settings"], **ov["settings"])
    assert res["metrics"]["probe.gflop"]["value"] == \
        7 * work.forward_flops(st, ov["traffic"]["tile_px"]) / 1e9
    assert _snapshot(spec.ROOT / "portbench") == before


def test_a_missing_family_fails_in_spec_cell(tmp_path, monkeypatch):
    """Before any weights are drawn, naming the file it looked for."""
    root = _tree(tmp_path)
    cfg = json.loads((root / "configs" / "fast-256.json").read_text())
    (root / "configs" / "ghost-256.json").write_text(
        json.dumps(dict(cfg, family="ghost")))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ghost-256.detect-b16",
                               "config": "ghost-256",
                               "traffic": "detect-b16", "chips": 1,
                               "why": "a test"})
    monkeypatch.setattr(spec, "HERE", root)

    def drawn(*a, **k):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(modelgen, "weights", drawn)
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(root / "families" /
                                           "ghost.py"))):
        spec.cell("ghost-256.detect-b16", bench)

