"""The layouts K2 (``roi_align_fused_blocked``) takes on the card, checked
by its wrapper before a launch, on CPU and meta tensors: 16-byte aligned
levels, a channel count up to 256 that is a multiple of 8 (bf16) or 16
(int8), out_size and sampling within the kernel's tables, and a staging
ring and weight tables that fit a block's shared memory (the layout
constants read from the kernel source); and the exactness of the kernel's
int8 dequantization route, mirrored in numpy."""

import os
import re

import numpy as np
import pytest
import torch

from roadsurf_tpu_torch.ops import roi_align_blocked_kernel as k2

torch.set_num_threads(1)

SIDES = (200, 100, 50, 25)          # P2..P5 of an 800 px image
# the device code K2 shares with K1 (roi_align_blocked.cu includes it)
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "roadsurf_tpu_torch", "csrc", "roi_align_staged.cuh")


def _inputs(C, dtype, device="meta", B=2, R=4, sides=SIDES):
    feats = tuple(torch.empty((B, s, s, C), dtype=dtype, device=device)
                  for s in sides)
    boxes = torch.empty((B, R, 4), device=device)
    lvl = torch.empty((B, R), dtype=torch.int32, device=device)
    scales = torch.empty(8, device=device) if dtype == torch.int8 else None
    return feats, boxes, lvl, scales


@pytest.mark.parametrize("C,dtype", [(256, torch.bfloat16),
                                     (8, torch.bfloat16),
                                     (256, torch.int8), (16, torch.int8)])
def test_blocked_wrapper_takes_the_parity_layouts(C, dtype):
    feats, boxes, lvl, scales = _inputs(C, dtype)
    for P, s in ((7, 0), (14, 0), (7, 2)):
        k2._check(feats, boxes, lvl, P, s, scales)


@pytest.mark.parametrize("C,dtype", [(12, torch.bfloat16),
                                     (264, torch.bfloat16),
                                     (24, torch.int8), (272, torch.int8)])
def test_blocked_wrapper_refuses_channel_counts(C, dtype):
    feats, boxes, lvl, scales = _inputs(C, dtype)
    with pytest.raises(ValueError, match="channel count"):
        k2._check(feats, boxes, lvl, 7, 0, scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_blocked_wrapper_refuses_levels_off_16_bytes(dtype):
    """A level 4 bytes into its storage passes the 4-byte rule both
    poolers share, and not K2's 16-byte one."""
    C, sides = 16, (8, 4)
    feats, boxes, lvl, scales = _inputs(C, dtype, "cpu", sides=sides)
    k2._check(feats, boxes, lvl, 7, 0, scales)
    n = feats[0].numel()
    shifted = torch.empty(n + 16, dtype=dtype)[4 // dtype.itemsize:][:n] \
        .view(feats[0].shape)
    assert shifted.data_ptr() % 16 and not shifted.data_ptr() % 4
    with pytest.raises(ValueError, match="16-byte"):
        k2._check((shifted,) + feats[1:], boxes, lvl, 7, 0, scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_blocked_wrapper_refuses_what_overflows_shared_memory(dtype):
    """The ring and the tables of P + band + 1 rows of the longest side:
    the parity sides fit at P = 7, 14 and 32 in both modes; a 2000-cell
    side does not."""
    int8 = dtype == torch.int8
    for P in (7, 14, 32):
        assert k2.smem_bytes(P, max(SIDES), int8) <= k2.KERNEL["kMaxSmem"]
    feats, boxes, lvl, scales = _inputs(256, dtype, sides=(2000,))
    assert k2.smem_bytes(14, 2000, int8) > k2.KERNEL["kMaxSmem"]
    with pytest.raises(ValueError, match="shared memory"):
        k2._check(feats, boxes, lvl, 14, 0, scales)
    assert k2.roi_align_fused_blocked.launches == 0


@pytest.mark.parametrize("P,s", [(0, 0), (k2.MAX_OUT + 1, 0), (7, -1),
                                 (7, k2.MAX_SAMPLING + 1)])
def test_blocked_wrapper_refuses_out_size_and_sampling(P, s):
    feats, boxes, lvl, scales = _inputs(256, torch.bfloat16)
    k2._check(feats, boxes, lvl, k2.MAX_OUT, k2.MAX_SAMPLING, scales)
    with pytest.raises(ValueError, match="unsupported"):
        k2._check(feats, boxes, lvl, P, s, scales)


def test_blocked_wrapper_constants_match_the_kernel_source():
    """The wrapper reads K2's layout constants from the source; the
    sampling limit it shares with K1's wrapper is the source's too."""
    src = open(CSRC).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    for name in ("kMaxOut", "kMaxSmem", "kLaneC", "kMaxWarps", "kStages",
                 "kStageBytes", "kStageBytes8"):
        assert k2.KERNEL[name] == const(name) > 0, name
    assert k2.MAX_SAMPLING == const("kMaxSampling")


@pytest.mark.parametrize("scale", [1.0, 0.0371, 4.0 / 127, 1e-3 / 3,
                                   2.0 ** -20 * 1.7, 123.456])
def test_int8_dequant_route_is_exact(scale):
    """The kernel's dequantization of a cell (``dequant16``): q + 128 in
    the low byte of 2^23's bits, minus 2^23 + 128, is q exactly; one f32
    product with the level's scale, rounded to bf16, is the plain
    version's ``bf16(q · s_l)`` for every q."""
    q = np.arange(-128, 128, dtype=np.int8)
    u = (q.view(np.uint8) ^ 0x80).astype(np.uint32)
    exact = (u | np.uint32(0x4B000000)).view(np.float32) \
        - np.float32(8388736.0)
    assert np.array_equal(exact, q.astype(np.float32))
    got = torch.from_numpy(exact * np.float32(scale)).to(torch.bfloat16)
    s = torch.tensor([scale], dtype=torch.float32)
    want = k2.dequantize((torch.from_numpy(q),), s)[0]
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
