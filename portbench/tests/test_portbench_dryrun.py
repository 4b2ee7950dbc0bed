"""Each cell of BENCHMARK.json run on the CPU, narrow and small, through
the harness the command runs: the window, the check and the metrics."""

import time

import pytest
from conftest import narrow

from portbench import spec
from portbench.harness import run_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_dry_run(name):
    cell = spec.cell(name)
    res = run_cell(cell, 2 ** 31 + 7, 0.3, False, time.perf_counter(),
                   device="cpu", overrides=narrow(cell))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["metrics"]["tiles_per_s"]["value"] > 0
    r = res["readings"]
    assert r["detections_program"] > 0
    assert r["detections_program"] == r["detections_reference"]
    assert r["unmatched"] == 0 and r["mask_err"] == 0
    assert r["box_err"] < 1e-5 and r["score_err"] < 1e-4
    assert list(res)[-1] == "checks"


def test_traced_dry_run():
    """With --trace 1 the per-layer metrics: the engine's from its stats;
    the device's read nothing on the CPU and are left out."""
    cell = spec.cell(CELLS[0])
    res = run_cell(cell, 5, 2.0, True, time.perf_counter(), device="cpu",
                   overrides=narrow(cell))
    assert res["correct"]
    assert {"engine.stage_ms", "engine.wait_ms"} <= set(res["metrics"])
    assert not {"mfu", "device.idle_share"} & set(res["metrics"])
    assert res["device"]["busy_s"] == 0.0
    assert res["breakdown"]["idle_gaps"]


def test_same_seed_same_inputs():
    """Weights and tiles come from the seed alone."""
    import torch

    from portbench import modelgen

    st = dict(spec.cell(CELLS[0]).config["settings"], **narrow(
        spec.cell(CELLS[0]))["settings"])
    a, b = (modelgen.generator(2 ** 31 + 3, "cpu") for _ in range(2))
    wa = modelgen.weights(st, a, "cpu", torch.float32)
    wb = modelgen.weights(st, b, "cpu", torch.float32)
    assert torch.equal(wa["box_head"]["fc1"]["w"], wb["box_head"]["fc1"]["w"])
    assert (modelgen.tiles(4, 32, a, "cpu")
            == modelgen.tiles(4, 32, b, "cpu")).all()
