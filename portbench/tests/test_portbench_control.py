"""The control on the card: the program's own int8 path (the precision
below the configurations' bf16) in the program's place must come out not
correct, at a size a test run holds (the cells' widths and budgets, small
batches, a 1 s window). The same at the cells' own size is
``python3 -m portbench.calibrate --control ...``."""

import time

import pytest

from portbench import spec
from portbench.calibrate import int8_control
from portbench.harness import run_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SMALL = {"batch": 8, "pool_tiles": 64, "check_tiles": 32, "check_block": 8,
         "trace_dispatches": 1}


@pytest.mark.card
@pytest.mark.parametrize("seed", [71, 72, 73])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, seed, card):
    cell = spec.cell(name)
    program = run_cell(cell, seed, 1.0, False, time.perf_counter(),
                       device=card, overrides={"traffic": SMALL})
    control = run_cell(cell, seed, 1.0, False, time.perf_counter(),
                       device=card, overrides={"traffic": SMALL},
                       prepare=int8_control)
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
