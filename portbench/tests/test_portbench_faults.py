"""The check catches a broken timed path: the rest of a run on the CPU,
narrow and small, with the program's forward broken underneath the
engine, against the configurations' own limits."""

import time

import pytest
from conftest import narrow

from portbench import spec
from portbench.harness import run_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def half_left_out(dets):
    """The second half of the batch produces nothing."""
    h = dets["valid"].shape[0] // 2
    dets["valid"][h:] = False
    dets["scores"][h:] = 0
    return dets


def boxes_moved(dets):
    dets["boxes"] = dets["boxes"] + 2.0
    return dets


def classes_swapped(dets):
    dets["classes"] = 1 - dets["classes"]
    return dets


def masks_inverted(dets):
    dets["mask_bits"] = 255 - dets["mask_bits"]
    return dets


@pytest.mark.parametrize("fault", [half_left_out, boxes_moved,
                                   classes_swapped, masks_inverted])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault, monkeypatch):
    import roadsurf_tpu_torch.engine.infer as infer

    real = infer.forward_prepared

    def broken(*a, **k):
        return fault(real(*a, **k))

    monkeypatch.setattr(infer, "forward_prepared", broken)
    cell = spec.cell(name)
    ov = narrow(cell)
    ov["traffic"]["check_tiles"] = 256     # every returned tile: both rows
    res = run_cell(cell, 99, 0.3, False, time.perf_counter(), device="cpu",
                   overrides=ov)
    assert res["readings"]["tiles"] == res["attempted"]
    assert res["readings"]["detections_reference"] > 0
    assert not res["correct"], res["checks"]


def test_unbroken_passes():
    cell = spec.cell(CELLS[0])
    res = run_cell(cell, 99, 0.3, False, time.perf_counter(), device="cpu",
                   overrides=narrow(cell))
    assert res["correct"], res["checks"]
