"""K1 (``roi_align_fused``) on the card runs the pooler device code it
shares with K2 (``csrc/roi_align_staged.cuh``). Here, on CPU and meta
tensors: the layouts its wrapper takes and refuses, with the layout
constants read from the kernel source; and numpy mirrors of the index
arithmetic the kernel relies on, held against the plain version's
weights at the fast profile's shapes (B=64 tiles of 256 px, P2..P4 at
64/32/16, s=2): every output bin written by exactly one (block, warp,
column), the rows and columns a block stages covering every non-zero
weight of its band, and the staged region cut into chunks that cover it
exactly once and fit a ring slot."""

import math
import os
import re

import numpy as np
import pytest
import torch

from roadsurf_tpu_torch.ops import roi_align_kernel as k1
from roadsurf_tpu_torch.ops.roi_align import level_assignment

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "roadsurf_tpu_torch", "csrc")
SIDES = (64, 32, 16)                # P2..P4 of a 256 px tile
F32 = np.float32


def _inputs(C, dtype, device="meta", B=2, R=4, sides=SIDES):
    feats = tuple(torch.empty((B, s, s, C), dtype=dtype, device=device)
                  for s in sides)
    boxes = torch.empty((B, R, 4), device=device)
    lvl = torch.empty((B, R), dtype=torch.int32, device=device)
    scales = torch.empty(8, device=device) if dtype == torch.int8 else None
    return feats, boxes, lvl, scales


# ---------------------------------------------------------------------------
# the wrapper's checks

@pytest.mark.parametrize("C,dtype", [(256, torch.bfloat16),
                                     (8, torch.bfloat16),
                                     (256, torch.int8), (16, torch.int8)])
def test_k1_wrapper_takes_the_fast_layouts(C, dtype):
    """The fast profile's poolers (P 7 and 14) and the edge batch's P = 28,
    at s = 2, in both modes."""
    feats, boxes, lvl, scales = _inputs(C, dtype)
    for P in (7, 14, 28):
        k1._check(feats, boxes, lvl, P, 2, scales)


@pytest.mark.parametrize("C,dtype", [(12, torch.bfloat16),
                                     (264, torch.bfloat16),
                                     (24, torch.int8), (272, torch.int8)])
def test_k1_wrapper_refuses_channel_counts(C, dtype):
    feats, boxes, lvl, scales = _inputs(C, dtype)
    with pytest.raises(ValueError, match="channel count"):
        k1._check(feats, boxes, lvl, 7, 2, scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_k1_wrapper_refuses_levels_off_16_bytes(dtype):
    """A level 4 bytes into its storage passes the 4-byte rule both
    poolers share, and not the bulk copies' 16-byte one."""
    feats, boxes, lvl, scales = _inputs(16, dtype, "cpu", sides=(8, 4))
    k1._check(feats, boxes, lvl, 7, 2, scales)
    n = feats[0].numel()
    shifted = torch.empty(n + 16, dtype=dtype)[4 // dtype.itemsize:][:n] \
        .view(feats[0].shape)
    assert shifted.data_ptr() % 16 and not shifted.data_ptr() % 4
    with pytest.raises(ValueError, match="16-byte"):
        k1._check((shifted,) + feats[1:], boxes, lvl, 7, 2, scales)


@pytest.mark.parametrize("P,s", [(0, 2), (k1.MAX_OUT + 1, 2), (7, 0),
                                 (7, k1.MAX_SAMPLING + 1)])
def test_k1_wrapper_refuses_out_size_and_sampling(P, s):
    """Fixed sampling only (0, adaptive, is K2's), P up to the shared
    kernel's tables."""
    feats, boxes, lvl, scales = _inputs(256, torch.bfloat16)
    k1._check(feats, boxes, lvl, k1.MAX_OUT, k1.MAX_SAMPLING, scales)
    with pytest.raises(ValueError, match="unsupported"):
        k1._check(feats, boxes, lvl, P, s, scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_k1_wrapper_refuses_what_overflows_shared_memory(dtype):
    """The dispatcher sends K1 maps of at most 160² cells at P2, which fit
    at every P in both modes; a 2000-cell side does not."""
    int8 = dtype == torch.int8
    for P in (7, 14, 28, k1.MAX_OUT):
        assert k1.smem_bytes(P, 160, int8) <= k1.KERNEL["kMaxSmem"]
    feats, boxes, lvl, scales = _inputs(256, dtype, sides=(2000,))
    with pytest.raises(ValueError, match="shared memory"):
        k1._check(feats, boxes, lvl, 14, 2, scales)
    assert k1.roi_align_fused.launches == k1.roi_align_fused.launches_int8 \
        == 0


def test_k1_shares_one_copy_of_the_device_code():
    """Both pooler sources include the shared header and define no kernel
    of their own; the wrapper's constants are the header's, and K1's
    compile-time kernels are the fast profile's poolers."""
    header = open(os.path.join(CSRC, "roi_align_staged.cuh")).read()
    for name in ("roi_align.cu", "roi_align_blocked.cu"):
        src = open(os.path.join(CSRC, name)).read()
        assert '#include "roi_align_staged.cuh"' in src
        assert "__global__" not in src and "__device__" not in src
    for name, v in re.findall(r"^constexpr int (k\w+) = (\d+);", header,
                              re.M):
        assert k1.KERNEL[name] == int(v)
    assert k1.MAX_SAMPLING == k1.KERNEL["kMaxSampling"] == 16
    specs = re.findall(r"roi_align_staged_kernel<T, (\d), (\d+), (\d+)>",
                       header)
    assert {(int(p), int(s)) for _, p, s in specs} == {(7, 2), (14, 2)}


# ---------------------------------------------------------------------------
# numpy mirrors of the kernel's index arithmetic (roi_align_staged.cuh)

def _split(P):
    """(columns a warp, band rows a block, warps): pooler_run's split."""
    warps = k1.KERNEL["kMaxWarps"]
    qpw = 1 if P <= warps else 2 if P <= 2 * warps else 4
    return qpw, warps // qpw, -(-P // qpw)


@pytest.mark.parametrize("R", [1, 8, 13, 32, 37])
def test_every_bin_is_written_by_one_block_warp_and_column(R):
    """Block b takes box b // n_bands and band rows p0 .. p0 + nb - 1;
    warp w of it the columns w + j·warps, j < qpw, below P."""
    B = 2
    for P in range(1, k1.MAX_OUT + 1):
        qpw, band, nwarps = _split(P)
        n_bands = -(-P // band)
        hits = np.zeros((B * R, P, P), np.int32)
        for blk in range(B * R * n_bands):
            roi = blk // n_bands
            p0 = (blk - roi * n_bands) * band
            nb = min(band, P - p0)
            assert nb >= 1
            for warp in range(nwarps):
                for j in range(qpw):
                    q = warp + j * nwarps
                    if q < P:
                        hits[roi, p0:p0 + nb, q] += 1
        assert (hits == 1).all(), P


def _tap_span(lo, hi, inv, dim):
    """tap_span: cells [s0, s1] that can carry weight for samples between
    image positions lo and hi (f32, inv a power of two: exact)."""
    last = F32(dim - 1)
    a = np.floor(F32(min(lo, hi)) * F32(inv) - F32(0.5)) - F32(1)
    b = np.floor(F32(max(lo, hi)) * F32(inv) - F32(0.5)) + F32(2)
    return int(min(max(a, F32(0)), last)), int(min(max(b, F32(0)), last))


def _bin_start(lo, bin_size, p):
    return F32(F32(lo) + F32(F32(p) * F32(bin_size)))


def _fast_boxes(seed, R):
    """Boxes as chip_smoke draws them for the fast profile (sides 4..256
    px in a 256 px tile) and its edge boxes, the full-width road among
    them."""
    rng = np.random.default_rng(seed)
    u = rng.random((1, R, 4), dtype=np.float32)
    x0, y0 = u[..., 0] * 256, u[..., 1] * 256
    w, h = 4 + u[..., 2] * 252, 4 + u[..., 3] * 252
    boxes = np.stack([x0, y0, np.minimum(x0 + w, 256),
                      np.minimum(y0 + h, 256)], -1).astype(F32)
    special = np.array([[0, 0, 0, 0], [100, 100, 100, 100],
                        [-40, -40, 300, 300], [250, 250, 290, 300],
                        [-20, 100, 10, 140], [0, 0, 256, 256],
                        [0, 0, 112, 112], [0, 0, 111.9, 111.9],
                        [10, 10, 234, 234], [10, 10, 233.9, 233.9],
                        [5, 100, 250, 101], [100, 5, 101, 250],
                        [255, 0, 256, 256], [-1, -1, 0, 0],
                        [-3, 10, 25, 38], [231, 10, 259, 38],
                        [0, 120, 256, 126], [120, 0, 126, 256]], F32)
    boxes[0, :len(special)] = special
    return boxes


@pytest.mark.parametrize("P", [7, 14, 28])
def test_staged_rows_and_columns_cover_every_nonzero_weight(P):
    """For each box of the fast geometry and each band of its output rows:
    the rows the block stages (the tap span of the band's bins) hold every
    row where the plain version's y-weights of the band are non-zero, the
    columns (the tap span of the box) every column of non-zero x-weight,
    and each bin's weights lie within the cells ``fill_weights`` evaluates
    for it (its own tap span, at most ceil(|bin| / stride) + 5 cells)."""
    R = 64
    boxes = _fast_boxes(P, R)
    tb = torch.from_numpy(boxes)
    lvl = level_assignment(tb, 224, 4, 2, 4)[0].numpy()
    x0, y0, bw, bh = (t[0].numpy() for t in k1.bin_sizes(tb, P))
    _, band, _ = _split(P)
    for r in range(R):
        li = int(lvl[r])
        side, stride = SIDES[li], float(2 ** (2 + li))
        inv = 1.0 / stride
        wy = k1._axis_weight_matrix(tb[0, r:r + 1, 1], k1.bin_sizes(
            tb, P)[3][0, r:r + 1], side, stride, P, 2)[0].numpy()
        wx = k1._axis_weight_matrix(tb[0, r:r + 1, 0], k1.bin_sizes(
            tb, P)[2][0, r:r + 1], side, stride, P, 2)[0].numpy()
        # columns: the box's span
        sx = _tap_span(boxes[0, r, 0], boxes[0, r, 2], inv, side)
        cols = np.nonzero(wx.any(0))[0]
        assert cols.size == 0 or (sx[0] <= cols.min()
                                  and cols.max() <= sx[1]), (r, sx, cols)
        # rows: each band's span
        for p0 in range(0, P, band):
            nb = min(band, P - p0)
            sy = _tap_span(_bin_start(y0[r], bh[r], p0),
                           _bin_start(y0[r], bh[r], p0 + nb), inv, side)
            rows = np.nonzero(wy[p0:p0 + nb].any(0))[0]
            assert rows.size == 0 or (sy[0] <= rows.min()
                                      and rows.max() <= sy[1]), (r, p0)
        # each bin's cells within the span fill_weights evaluates
        for w_axis, lo, bin_size, s0, s1 in (
                (wx, x0[r], bw[r], *sx), (wy, y0[r], bh[r], 0, side - 1)):
            n = s1 - s0 + 1
            span = min(n, math.ceil(abs(float(bin_size)) * inv) + 5)
            for p in range(P):
                t = _tap_span(_bin_start(lo, bin_size, p),
                              _bin_start(lo, bin_size, p + 1), inv, side)
                first = max(t[0], s0)
                last = min(t[1], s0 + n - 1, first + span - 1)
                nz = np.nonzero(w_axis[p])[0]
                assert nz.size == 0 or (first <= nz.min()
                                        and nz.max() <= last), (r, p)


@pytest.mark.parametrize("int8", [False, True])
def test_staged_region_chunks_cover_it_once_and_fit_a_slot(int8):
    """Region::chunk: whole rows a chunk when a row fits a ring slot, else
    row segments; over the fast profile's regions (up to the full 64-cell
    width at P2) and wider ones, every cell once, each chunk within its
    slot."""
    k = k1.KERNEL
    C = 256
    cell = C * (1 if int8 else 2)
    slot = k["kStageBytes8"] if int8 else k["kStageBytes"]
    cap = slot // cell
    for nx in list(range(1, 70)) + [150, 200, 201]:
        for ny in (1, 2, 7, 29, 64):
            rows_per = cap // nx if nx <= cap else 1
            segs = 1 if nx <= cap else -(-nx // cap)
            chunks = -(-ny // rows_per) if segs == 1 else ny * segs
            seen = np.zeros((ny, nx), np.int32)
            for c in range(chunks):
                if segs == 1:
                    y = c * rows_per
                    nr, xs, ncx = min(rows_per, ny - y), 0, nx
                else:
                    y, nr = c // segs, 1
                    xs = (c % segs) * cap
                    ncx = min(cap, nx - xs)
                assert nr * ncx * cell <= slot
                seen[y:y + nr, xs:xs + ncx] += 1
            assert (seen == 1).all(), (nx, ny)
