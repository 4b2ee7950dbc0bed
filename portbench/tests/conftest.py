"""The benchmark's own tests (``python -m pytest portbench/tests``; the
repository's tier-1 lane, ``pytest tests/``, does not collect them).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where no CUDA device is present; run them on the
card with ``python -m pytest portbench/tests -m card``. The CPU tests run a
narrow model on small tiles through the same harness code (``narrow``), at
the widths its family gives (``NARROW`` of ``families/<name>.py``, which
may also replace the sizes below)."""

import pytest
import torch

# sizes and budgets of the CPU runs; the precision is float32, so that the
# program and the reference agree to rounding
SMALL_PARITY = {"min_size_test": 96, "rpn_pre_nms_topk_test": 120,
                "rpn_post_nms_topk_test": 60, "detections_per_image": 12}
SMALL_TRAFFIC = {"batch": 2, "tile_px": 64, "pool_tiles": 8,
                 "check_tiles": 4, "check_block": 4, "trace_dispatches": 1}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda:0")


def narrow(cell) -> dict:
    """The overrides that run ``cell`` narrow and small on the CPU."""
    st = dict(SMALL_PARITY if cell.config["settings"]["min_size_test"]
              != 256 else {"min_size_test": 64})
    st.update(cell.family.NARROW, compute_dtype="float32")
    return {"settings": st, "precision": "float32",
            "traffic": dict(SMALL_TRAFFIC)}
