"""The work counts behind ``mfu`` and the kernel rooflines, against
hand-worked shapes and against the reference's own products."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import narrow
from portbench import modelgen, reference, spec, work
from portbench.harness import Context, Work
from portbench.window import Window

PARITY_CELL = spec.cell("parity-800.detect-b16")
PARITY = PARITY_CELL.config["settings"]
FAST = spec.cell("fast-256.area-b512-k4").config["settings"]


def test_hand_worked_shapes():
    assert work.level_sizes(800) == [200, 100, 50, 25, 13]
    assert work.level_sizes(256) == [64, 32, 16, 8, 4]
    assert work.conv_flops(3, 64, 7, 400, 400) == 2 * 3 * 64 * 49 * 400 ** 2
    # box pooler: 1000 boxes, 7x7x256 bf16 out; mask: 100 boxes, 14x14
    assert work.pooler_bytes(PARITY, "bfloat16") == \
        1000 * 16 + 1000 * 49 * 256 * 2 + 100 * 16 + 100 * 196 * 256 * 2
    assert work.pooler_bytes(FAST, "bfloat16") == \
        32 * 16 + 32 * 49 * 256 * 2 + 8 * 16 + 8 * 196 * 256 * 2
    # RPN: 1000 of 120000, 30000, 7500, 1875 anchors and 507 at P6;
    # classes: 1000 proposals x 2
    assert work.nms_bytes(PARITY) == (4 * 1000 + 507 + 2000) * 21
    # the whole forward: the port's FlopCounterMode figures (PR 16)
    assert work.forward_flops(PARITY, 256) / 1e9 == pytest.approx(366.09,
                                                                  abs=0.01)
    assert work.forward_flops(FAST, 256) / 1e9 == pytest.approx(33.09,
                                                                abs=0.01)


@pytest.mark.parametrize("name", ["parity-800.detect-b16",
                                  "fast-256.area-b512-k4"])
def test_flops_are_the_references(name):
    """The count equals what FlopCounterMode sees of the reference's
    convolutions and products at the budgets' shapes (narrow widths)."""
    cell = spec.cell(name)
    st = dict(cell.config["settings"], **narrow(cell)["settings"])
    W = modelgen.weights(st, modelgen.generator(1, "cpu"), "cpu",
                         torch.float32)
    T = 64
    x = torch.zeros(1, T, T, 3, dtype=torch.uint8)
    R, D = st["rpn_post_nms_topk_test"], st["detections_per_image"]
    C, P, Pm = st["fpn_channels"], st["box_pooler_resolution"], \
        st["mask_pooler_resolution"]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        feats = reference.backbone_fpn(W, reference.preprocess(x, st))
        reference.rpn(W, feats)
        reference.box_head(W, torch.zeros(R, C, P, P))
        m = torch.zeros(D, C, Pm, Pm)
        for i in range(st["mask_num_conv"]):
            m = reference._conv(m, W["mask_head"][f"conv{i + 1}"])
        d = W["mask_head"]["deconv"]
        m = torch.nn.functional.conv_transpose2d(m, d["w"], d["b"], stride=2)
        reference._conv(m, W["mask_head"]["predictor"])
    assert counter.get_total_flops() == work.forward_flops(st, T)


def _ctx(trace, settings=PARITY, batch=16):
    return Context(window=Window(), setup_s=1.0, stats={}, dispatches=0,
                   batch=batch, tile_px=256, settings=settings,
                   precision="bfloat16", capture_s=None, trace=trace,
                   work=Work(PARITY_CELL.family))


def test_readers_from_a_trace():
    """mfu and the rooflines from a traced stretch: 10 forwards of 16
    tiles (20 pooler launches) in 0.4 s."""
    trace = {"window_s": 0.4, "busy_s": 0.38,
             "by_category": {"roi_align": 0.02, "nms": 0.004, "conv": 0.2},
             "launches": {"roi_align": 20, "nms": 20, "conv": 900}}
    ctx = _ctx(trace)
    tiles = 10 * 16
    assert spec.reader("mfu")(ctx) == pytest.approx(
        work.forward_flops(PARITY, 256) * tiles / 0.4 / 989e12 * 100)
    assert spec.reader("kernels.pooler_roofline")(ctx) == pytest.approx(
        work.pooler_bytes(PARITY, "bfloat16") * tiles / 3.35e12 / 0.02 * 100)
    assert spec.reader("kernels.nms_roofline")(ctx) == pytest.approx(
        work.nms_bytes(PARITY) * tiles / 3.35e12 / 0.004 * 100)
    assert spec.reader("forward.conv_us")(ctx) == pytest.approx(
        0.2 / tiles * 1e6)
    assert spec.reader("device.idle_share")(ctx) == pytest.approx(5.0)
    assert spec.reader("forward.elementwise_us")(ctx) is None
    fast = _ctx(trace, FAST, 512)
    assert spec.reader("kernels.nms_roofline")(fast) is None


def test_readers_without_a_trace():
    ctx = _ctx(None)
    for name in ("mfu", "kernels.pooler_roofline", "kernels.nms_roofline",
                 "forward.conv_us", "device.idle_share"):
        assert spec.reader(name)(ctx) is None
