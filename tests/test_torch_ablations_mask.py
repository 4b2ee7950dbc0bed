"""``tools/ablate_mask_bits.py`` cut down on the CPU, once for the module,
on a workdir that ``tools/ablate_seeded.py`` builds (its ``build_scene``
and ``train_seeds`` at ``quality.CUT``'s sizes: a 4 x 4 grid, 2 seeds of
2 steps at 64 px) without the seeded run's own scoring: asked for 3
seeds, it skips the third, which has no checkpoint, scores each of the
others with the u8 and then the bits downlink, and writes the script's
keys, the paired differences and their largest magnitude.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from roadsurf_tpu_torch.tools import ablate_mask_bits, ablate_seeded, quality
from roadsurf_tpu_torch.utils.config import load_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    wd = tmp_path_factory.mktemp("ablate_mask_bits") / "seeded"
    wd.mkdir()
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        ablate_seeded.build_scene(load_config(quality.CONFIG),
                                  quality.CUT["n_grid"])
        ckpts = ablate_seeded.train_seeds(
            ablate_seeded.cut_config(quality.quality_config(2)), 2, 2, 2,
            quality.CUT["image_size"], "cpu")
    finally:
        os.chdir(cwd)
    res = ablate_mask_bits.run(str(wd), seeds=3, device="cpu", cut=True)
    with open(wd / "ablate_mask_bits.json") as f:
        written = json.load(f)
    return {"res": res, "written": written, "ckpts": ckpts,
            "cwd": (cwd, os.getcwd())}


def _f1(paired) -> dict:
    return {(r["seed"], r["fmt"]): r["f1b"]
            for r in paired["res"]["per_seed"]}


def test_each_trained_seed_has_its_last_checkpoint(paired):
    assert {s: os.path.basename(c) for s, c in paired["ckpts"].items()} \
        == {0: "model_0000001.npz", 1: "model_0000001.npz"}


def test_the_json_has_the_scripts_keys_and_is_written(paired):
    assert set(paired["res"]) == {"per_seed", "delta_bits_minus_u8",
                                  "max_abs_delta"}
    assert paired["written"] == paired["res"]


def test_the_seed_without_a_checkpoint_is_skipped(paired):
    assert [(r["seed"], r["fmt"]) for r in paired["res"]["per_seed"]] == [
        (0, "u8"), (0, "bits"), (1, "u8"), (1, "bits")]


def test_every_f1_is_a_fraction(paired):
    assert all(0.0 <= v <= 1.0 for v in _f1(paired).values())


@pytest.mark.parametrize("seed", [0, 1])
def test_each_delta_is_the_seeds_paired_difference(paired, seed):
    f1 = _f1(paired)
    assert paired["res"]["delta_bits_minus_u8"][seed] == round(
        f1[seed, "bits"] - f1[seed, "u8"], 4)


def test_the_largest_delta_is_their_largest_magnitude(paired):
    deltas = paired["res"]["delta_bits_minus_u8"]
    assert len(deltas) == 2
    assert paired["res"]["max_abs_delta"] == round(
        max(abs(d) for d in deltas), 4)


def test_the_run_restores_the_working_directory(paired):
    before, after = paired["cwd"]
    assert after == before
