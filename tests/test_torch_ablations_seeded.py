"""``tools/ablate_seeded.py`` cut down on the CPU (``quality.CUT``: a 4 x 4
road grid, 64 px, narrow float32 heads, budgets clipped to 64 proposals
and 8 detections): 2 seeds of 2 training steps, each scored under
fast-R64 and exact(R1000,D100), once for the module. The summary has the
script's keys, its means and its pandas standard deviations (ddof 1) of
the runs; each seed trained its own weights; and the reference's
``evaluate.run`` on the detection files the last run wrote gives every
table, chart and class shapefile equal byte for byte to the port's.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from roadsurf_tpu_torch.tools import ablate_seeded, quality
from roadsurf_tpu_torch.utils.weights import load_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ["fast-R64", "exact(R1000,D100)"]
DATASETS = ("trn", "val", "tst", "oth")
# what final_metrics writes under outputs/final
FINAL_FILES = (
    "tables/by_class_metrics.csv", "tables/global metrics.csv",
    "images/precision_vs_recall_over_validation_set.html",
    "images/precision_vs_recall_dep_on_class_over_val_set.html",
    "images/TP-FN-FP_vs_threshold_dep_on_class_over_val_set.html",
    "images/metrics_vs_threshold_over_validation_set.html",
    "images/metrics_vs_score_diff_threshold_dep_on_class.html",
    "images/reliability_diagram.html")


def _files(d: Path) -> dict:
    out = {}
    for sub, _, names in os.walk(d / "outputs" / "final"):
        for n in names:
            p = os.path.join(sub, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d / "outputs" / "final")] = f.read()
    return out


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The cut ablation's result, its JSON, the working directory before
    and after, and the final metrics of the port and of the reference's
    ``evaluate.run`` on a copy of the workdir."""
    from roadsurf_tpu.pipeline import evaluate as jevaluate
    from roadsurf_tpu_torch.utils.config import load_config

    tmp = tmp_path_factory.mktemp("ablate_seeded")
    wd = tmp / "seeded"
    cwd = os.getcwd()
    res = ablate_seeded.run(str(wd), seeds=2, iters=2, batch=2,
                            variants=VARIANTS, device="cpu", cut=True)
    after = os.getcwd()
    with open(wd / "ablate_seeded.json") as f:
        out = json.load(f)
    ref_wd = tmp / "ref"
    shutil.copytree(wd, ref_wd)
    shutil.rmtree(ref_wd / "outputs" / "final")
    cfg = load_config(str(ROOT / "config" / "config_obj_detec.yaml"))
    os.chdir(ref_wd)
    try:
        jevaluate.run(cfg["final_metrics.py"])
    finally:
        os.chdir(cwd)
    return {"res": res, "out": out, "wd": wd, "cwd": (cwd, after),
            "port": _files(wd), "ref": _files(ref_wd)}


def test_the_json_has_the_scripts_keys(seeded):
    out = seeded["out"]
    assert set(out) == {"summary", "seeds", "iters", "elapsed_s"}
    assert (out["seeds"], out["iters"]) == (2, 2)
    assert list(out["summary"]) == sorted(VARIANTS)
    assert {k: v for k, v in seeded["res"].items() if k != "rows"} == out


def test_the_runs_follow_the_tables_order_seed_by_seed(seeded):
    assert [(r["variant"], r["seed"]) for r in seeded["res"]["rows"]] == [
        (v, s) for v in ablate_seeded.VARIANTS if v in VARIANTS
        for s in (0, 1)]


def _runs(seeded, name: str) -> list:
    return [r["f1b"] for r in seeded["res"]["rows"] if r["variant"] == name]


@pytest.mark.parametrize("name", VARIANTS)
def test_the_summary_holds_the_runs_and_their_mean(seeded, name):
    runs = _runs(seeded, name)
    got = seeded["out"]["summary"][name]
    assert got["runs"] == runs and len(runs) == 2
    assert all(0.0 <= v <= 1.0 for v in runs)
    assert got["mean"] == round(float(np.mean(runs)), 4)


@pytest.mark.parametrize("name", VARIANTS)
def test_the_std_is_the_scripts_pandas_std_with_ddof_1(seeded, name):
    runs = _runs(seeded, name)
    got = seeded["out"]["summary"][name]["std"]
    assert got == round(float(pd.Series(runs).std(ddof=1)), 4)
    assert got == round(float(np.std(runs, ddof=1)), 4)


def test_every_run_wrote_each_datasets_detections(seeded):
    want = {f"{ds}_detections_at_0dot05_threshold.gpkg" for ds in DATASETS
            if (seeded["wd"] / quality.OD / f"COCO_{ds}.json").exists()}
    assert {"trn_detections_at_0dot05_threshold.gpkg"} <= want
    for r in seeded["res"]["rows"]:
        assert set(r["files"]) == want, r
        assert r["peak_bytes"] is None and r["seconds"] > 0
        assert 0.0 <= r["baseline_f1"] <= 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_each_seed_kept_its_two_checkpoints(seeded, seed):
    logs = seeded["wd"] / quality.OD / f"logs_seed{seed}"
    assert sorted(p.name for p in logs.glob("model_*.npz")) == [
        "model_0000000.npz", "model_0000001.npz"]


def test_each_seed_trained_its_own_weights(seeded):
    """Sampling seeds 1000 and 1001, each its own init and draws."""
    od = seeded["wd"] / quality.OD
    trees = [load_params(str(od / f"logs_seed{s}" / "model_0000001.npz"))[0]
             for s in (0, 1)]
    w0, w1 = (t["box_head"]["cls"]["w"] for t in trees)
    assert w0.shape == w1.shape and not np.array_equal(w0, w1)


def test_the_run_restores_the_working_directory(seeded):
    before, after = seeded["cwd"]
    assert after == before


def test_the_reference_writes_the_same_final_files(seeded):
    assert sorted(seeded["port"]) == sorted(seeded["ref"])
    assert set(FINAL_FILES) <= set(seeded["port"])


@pytest.mark.parametrize("name", FINAL_FILES)
def test_the_references_final_metrics_equal_byte_for_byte(seeded, name):
    assert seeded["port"][name] == seeded["ref"][name]


def test_the_references_class_shapefiles_equal_byte_for_byte(seeded):
    shp = [f for f in seeded["port"] if f.startswith("shp_gpkg/")]
    assert len(shp) >= 4
    assert [f for f in shp if seeded["port"][f] != seeded["ref"][f]] == []
