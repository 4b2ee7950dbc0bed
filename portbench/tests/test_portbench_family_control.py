"""The control of a family that brings its own (``families/<name>.py``'s
``control``, for a configuration with no int8 path) on the card: the
program must come out correct and the control, in its place, not correct,
at a size a test run holds (the cell's widths and budgets, small batches,
a 1 s window). ``test_portbench_control.py`` holds the int8 control of the
families without one."""

import time

import pytest

from portbench import spec
from portbench.harness import run_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]
         if hasattr(spec.cell(w["name"]).family, "control")]
SMALL = {"batch": 8, "pool_tiles": 64, "check_tiles": 32, "check_block": 8,
         "trace_dispatches": 1}


def test_a_family_with_a_control_has_a_cell():
    assert "vitdet-b-1024.detect-b16" in CELLS


@pytest.mark.card
@pytest.mark.parametrize("seed", [71, 72, 73])
@pytest.mark.parametrize("name", CELLS)
def test_the_familys_control_fails(name, seed, card):
    cell = spec.cell(name)
    program = run_cell(cell, seed, 1.0, False, time.perf_counter(),
                       device=card, overrides={"traffic": SMALL})
    control = run_cell(cell, seed, 1.0, False, time.perf_counter(),
                       device=card, overrides={"traffic": SMALL},
                       prepare=cell.family.control)
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
