"""The pooler's gradient in the PyTorch port: ``ops/roi_align.py``'s
``RoIAlignFunction`` (forward K1 or K2, backward K5; here on the CPU their
plain versions) against ``jax.vjp`` of the JAX package's
``roi_align_multilevel`` (its XLA separable pooler, whose autodiff the
reference trains with), and numpy mirrors of K5's index ranges and of its
sums, which only the card runs.

Inputs: 4 levels of a 512 px image (P2..P5 reachable), boxes that span the
levels, padded zero GT boxes and boxes on and across the borders; fixed
2x2 sampling (K1's route at P7) and adaptive sampling (K2's route at P7
and P14).

Tolerances: the gradient atol 1e-5 (f32 sums in other orders of values of
order 1); the mirror of K5's sums atol 1e-5 against the plain gradient;
its evaluated cells exact (every non-zero weight of a tile inside them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadsurf_tpu.ops.roi_align import roi_align_multilevel as j_pool
from roadsurf_tpu_torch.ops import roi_align as tra
from roadsurf_tpu_torch.ops.roi_align_backward_kernel import KERNEL as BWD, \
    TILE_H, _check, chunk_c, part_bins, roi_align_backward, \
    roi_align_backward_ref, smem_bytes, tile_w
from roadsurf_tpu_torch.ops.roi_align_kernel import KERNEL, axis_weights, \
    roi_align_fused_ref

torch.set_num_threads(1)

SIDE, C, B = 512, 8, 2
LEVELS = (128, 64, 32, 16)


def _inputs(R: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, s, s, C)).astype(np.float32)
             for s in LEVELS]
    x0, y0 = rng.uniform(0, SIDE, (2, B, R))
    w, h = 2 * (SIDE / 2) ** rng.uniform(0, 1, (2, B, R))
    boxes = np.stack([x0, y0, np.minimum(x0 + w, SIDE),
                      np.minimum(y0 + h, SIDE)], -1).astype(np.float32)
    special = np.asarray([
        [0, 0, 0, 0], [0, 0, 0, 0],                # padded GT boxes
        [0, 0, SIDE, SIDE],                        # P5
        [0, 200, SIDE, 206],                       # full-width thin road
        [10, 10, 40, 40], [20, 20, 160, 160],      # P2, P3
        [0, 0, 300, 300],                          # P4
        [0, 0, 112, 112], [0, 0, 111.9, 111.9],    # a level boundary
        [-50, 100, 40, 140],                       # across the left border
        [SIDE - 20, SIDE - 20, SIDE + 30, SIDE + 10],
        [SIDE - 1, 0, SIDE, SIDE],                 # the last column
        [-4, 100, 24, 128],                        # a sample at c = -1
    ], np.float32)
    boxes[:, :len(special)] = special
    return feats, boxes, rng


@pytest.mark.parametrize("P,sampling", [(7, 2), (7, 0), (14, 0)])
def test_pooler_gradient_matches_jax_vjp(P, sampling):
    feats, boxes, rng = _inputs(40)
    dout = rng.normal(size=(B, 40, P, P, C)).astype(np.float32)

    def f(*levels):
        return j_pool(list(levels), jnp.asarray(boxes), P, sampling=sampling)

    out, vjp = jax.vjp(f, *[jnp.asarray(x) for x in feats])
    ref = vjp(jnp.asarray(dout))

    levels = [torch.from_numpy(x).requires_grad_() for x in feats]
    got_out = tra.roi_align_multilevel(levels, torch.from_numpy(boxes), P,
                                       sampling=sampling)
    assert got_out.grad_fn is not None
    assert type(got_out.grad_fn).__name__ == "RoIAlignFunctionBackward"
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    got = torch.autograd.grad(got_out, levels, torch.from_numpy(dout))
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    # every level takes part: boxes on each
    assert all(float(np.abs(np.asarray(r)).max()) > 0 for r in ref)


def test_backward_equals_autograd_through_the_plain_pooler():
    """The explicit transposed contractions (K5's plain version) give what
    autograd gives through the plain forward."""
    feats, boxes, rng = _inputs(24, seed=1)
    P, s = 7, 0
    lv = [torch.from_numpy(x) for x in feats]
    bx = torch.from_numpy(boxes)
    lvl = tra.level_assignment(bx, 224, 4, 2, 5).contiguous()
    dout = torch.from_numpy(rng.normal(size=(B, 24, P, P, C))
                            .astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in lv]
    out = roi_align_fused_ref(tuple(leaves), bx, lvl, P, s)
    ref = torch.autograd.grad(out, leaves, dout)
    got = roi_align_backward(dout, [x.shape for x in lv], bx, lvl, P, s,
                             dtype=torch.float32)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# numpy mirror of K5 (csrc/roi_align_backward.cu): its tiles and channel
# chunks at the kernel's own sizes, its culling, its weights over the tile
# only and its per-tile sums in ascending box order

f32 = np.float32
INT_MAX = 2 ** 31 - 1


def _tap_span(lo, hi, inv, dim):
    """roi_align_staged.cuh::tap_span in float32."""
    last = f32(dim - 1)
    a = np.floor(f32(min(lo, hi)) * f32(inv) - f32(0.5)) - f32(1)
    b = np.floor(f32(max(lo, hi)) * f32(inv) - f32(0.5)) + f32(2)
    return int(min(max(a, 0), last)), int(min(max(b, 0), last))


def _bin_start(lo, binsz, p):
    return f32(f32(lo) + f32(f32(p) * f32(binsz)))


def _axis(lo, hi, P, stride):
    """(bin size, 1 / stride) of a box along one axis, as the kernel."""
    return f32(f32(f32(hi) - f32(lo)) / f32(P)), f32(1.0) / f32(stride)


def _region(lo, hi, P, stride, dim):
    """The tap span of the box's first and last bin edges: the cells the
    kernel's culling tests against a tile."""
    binsz, inv = _axis(lo, hi, P, stride)
    return _tap_span(_bin_start(lo, binsz, 0), _bin_start(lo, binsz, P),
                     inv, dim)


def _tile_weights(w, lo, hi, P, stride, dim, s0, n):
    """fill_axis: each bin's weights at its evaluated cells, its tap span
    within [s0, s0 + n - 1] and at most ceil(|bin| / stride) + 5 cells,
    into a zeroed (P, n) table, with each bin's first and last cell of
    non-zero weight. ``w``: the plain version's (P, dim) weights; every
    non-zero one inside the tile must lie at an evaluated cell."""
    binsz, inv = _axis(lo, hi, P, stride)
    span = min(n, int(np.ceil(f32(abs(binsz)) * inv)) + 5)
    table = np.zeros((P, n), f32)
    rng = [(INT_MAX, -1)] * P
    for p in range(P):
        t0, t1 = _tap_span(_bin_start(lo, binsz, p),
                           _bin_start(lo, binsz, p + 1), inv, dim)
        c0 = max(t0, s0)
        c1 = min(c0 + span - 1, t1, s0 + n - 1)
        inside = w[p, s0:s0 + n].copy()
        if c0 <= c1:
            table[p, c0 - s0:c1 - s0 + 1] = w[p, c0:c1 + 1]
            inside[c0 - s0:c1 - s0 + 1] = 0
            nz = np.flatnonzero(w[p, c0:c1 + 1])
            if len(nz):
                rng[p] = (c0 + nz[0], c0 + nz[-1])
        np.testing.assert_array_equal(inside, 0)
    return table, rng


def _mirror(dout, boxes, lvl, P, s, shapes):
    """K5's gradients: per (image, level, tile, channel chunk) the culled
    boxes in ascending index; per box and bin row p that weighs the tile,
    t = Σ_q wx[q, x] dP[p, q] over each column's range of bins (zeros
    where a bin of the range does not weigh the column), then acc[y] +=
    wy[p, y] t over the rows bin p weighs; f32 sums in the kernel's order.
    Also returns, per level, the culled (tile, box) pairs whose region
    ends just before, ends on, starts on or straddles a tile edge."""
    TH, TW, CC = TILE_H, tile_w(P), chunk_c(P)
    pbins = part_bins(P)
    B, R = boxes.shape[:2]
    metas = tuple(torch.empty(sh, device="meta") for sh in shapes)
    grads = [np.zeros(sh, f32) for sh in shapes]
    edges = {"miss": 0, "on": 0, "straddle": 0}
    for b in range(B):
        ws = axis_weights(tuple(m[b:b + 1] for m in metas),
                          torch.from_numpy(boxes[b:b + 1]),
                          torch.from_numpy(lvl[b:b + 1]), P, s, 2)
        for l, sh in enumerate(shapes):
            H, W, C = sh[1:]
            st = 2 ** (2 + l)
            on = [r for r in range(R)
                  if min(max(int(lvl[b, r]), 0), len(shapes) - 1) == l]
            reg = {r: (_region(boxes[b, r, 0], boxes[b, r, 2], P, st, W),
                       _region(boxes[b, r, 1], boxes[b, r, 3], P, st, H))
                   for r in on}
            wy_full = ws[l][0][0].numpy()
            wx_full = ws[l][1][0].numpy()
            for ty0 in range(0, H, TH):
                for tx0 in range(0, W, TW):
                    kept = []
                    for r in on:
                        (xa, xb), (ya, yb) = reg[r]
                        if xa < tx0 + TW and xb >= tx0 and ya < ty0 + TH \
                                and yb >= ty0:
                            kept.append(r)
                            straddle = xa < tx0 <= xb or ya < ty0 <= yb
                            edges["straddle"] += straddle
                            edges["on"] += xa == tx0 or ya == ty0 \
                                or xb == tx0 + TW - 1 or yb == ty0 + TH - 1
                        else:
                            x_in = xa < tx0 + TW and xb >= tx0
                            y_in = ya < ty0 + TH and yb >= ty0
                            edges["miss"] += (xb == tx0 - 1 and y_in) \
                                or (yb == ty0 - 1 and x_in)
                    for c0 in range(0, C, CC):
                        acc = np.zeros((TH, TW, CC), f32)
                        for r in kept:
                            x0, y0, x1, y1 = boxes[b, r]
                            wy, yr = _tile_weights(wy_full[r], y0, y1, P, st,
                                                   H, ty0, TH)
                            wx, _ = _tile_weights(wx_full[r], x0, x1, P, st,
                                                  W, tx0, TW)
                            # each column's range of bins of non-zero
                            # weight (the others in it weigh 0)
                            m = np.zeros((P, TW), f32)
                            for xl in range(TW):
                                qs = np.flatnonzero(wx[:, xl])
                                if len(qs):
                                    m[qs[0]:qs[-1] + 1, xl] = \
                                        wx[qs[0]:qs[-1] + 1, xl]
                            g = np.zeros((P, P, CC), f32)
                            g[..., :min(CC, C - c0)] = dout[b, r, :, :,
                                                            c0:c0 + CC]
                            for p0 in range(0, P, pbins):
                                for p in range(p0, min(P, p0 + pbins)):
                                    if yr[p][0] > yr[p][1]:
                                        continue
                                    t = np.zeros((TW, CC), f32)
                                    for q in range(P):
                                        t += m[q][:, None] * g[p, q][None]
                                    for i in range(TH):
                                        if yr[p][0] <= ty0 + i <= yr[p][1]:
                                            acc[i] += wy[p, i] * t
                        hh, ww = min(TH, H - ty0), min(TW, W - tx0)
                        cc = min(CC, C - c0)
                        grads[l][b, ty0:ty0 + hh, tx0:tx0 + ww,
                                 c0:c0 + cc] = acc[:hh, :ww, :cc]
    return grads, edges


def _edge_boxes(P: int) -> np.ndarray:
    """Boxes on every level of the 512 px image whose region (the tap span
    the kernel culls by) ends or starts within two cells of a tile edge of
    the kernel's tiles at P, in x and in y (the region's outer cells are a
    margin of zero weight, so only those two cells decide), and boxes that
    straddle one."""
    sizes = (40, 150, 300, 480)   # sqrt(area) within each level's range
    out = []
    for l, w in enumerate(sizes):
        st = 2 ** (2 + l)
        dim = LEVELS[l]
        for axis, step in ((0, tile_w(P)), (1, TILE_H)):
            for e in range(step, dim, step)[:2]:
                for d in (-2, -1, 0, 1):
                    hi = (e + d - 1) * st          # the region ends at e + d
                    lo = (e + d + 1.5) * st        # the region starts at e + d
                    for a0, a1 in ((hi - w, hi), (lo, lo + w),
                                   (e * st - w / 2, e * st + w / 2)):
                        o0 = SIDE / 2 - w / 2 + 7 * d   # the other axis
                        box = [a0, o0, a1, o0 + w] if axis == 0 \
                            else [o0, a0, o0 + w, a1]
                        out.append(box)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("P,sampling", [(7, 2), (7, 0), (14, 2), (14, 0)])
def test_k5_mirror_ranges_and_sums(P, sampling):
    """The mirror of K5's tiles, culling, weights over the tile and sums
    against the plain gradient, on the random and special boxes; C = 72
    makes the narrow tiles' (P = 14) two channel chunks, the second
    short."""
    Cm = 72
    feats, boxes, rng = _inputs(20, seed=2)
    shapes = [(*x.shape[:3], Cm) for x in feats]
    bx = torch.from_numpy(boxes)
    lvl = tra.level_assignment(bx, 224, 4, 2, 5).contiguous().numpy()
    dout = rng.normal(size=(B, 20, P, P, Cm)).astype(np.float32)
    ref = roi_align_backward_ref(torch.from_numpy(dout), shapes, bx,
                                 torch.from_numpy(lvl), P, sampling)
    got, _ = _mirror(dout, boxes, lvl, P, sampling, shapes)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5)
    assert set(lvl.flatten().tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("P,sampling", [(7, 2), (7, 0), (14, 2), (14, 0)])
def test_k5_mirror_tile_edges(P, sampling):
    """Boxes whose region falls on, straddles and just misses the edges of
    the kernel's tiles, on all four levels: the mirror's culling keeps
    every box that weighs a tile, and its sums equal the plain
    gradient."""
    eb = _edge_boxes(P)
    boxes = np.stack([eb, eb[::-1]])
    bx = torch.from_numpy(boxes)
    lvl = tra.level_assignment(bx, 224, 4, 2, 5).contiguous().numpy()
    assert set(lvl.flatten().tolist()) == {0, 1, 2, 3}
    R = boxes.shape[1]
    rng = np.random.default_rng(3)
    dout = rng.normal(size=(B, R, P, P, C)).astype(np.float32)
    shapes = [(B, s, s, C) for s in LEVELS]
    ref = roi_align_backward_ref(torch.from_numpy(dout), shapes, bx,
                                 torch.from_numpy(lvl), P, sampling)
    got, edges = _mirror(dout, boxes, lvl, P, sampling, shapes)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5)
    assert all(v > 0 for v in edges.values()), edges


def test_k5_takes_the_training_shapes():
    """A block's shared memory (the ring of d pooled slices, the weight
    tables over the tile, the culled list) depends on P alone: it fits at
    every P up to 32, whatever the levels' sides, two blocks an SM at the
    poolers' P 7 and 14."""
    for P in range(1, KERNEL["kMaxOut"] + 1):
        assert smem_bytes(P) <= KERNEL["kMaxSmem"]
        assert part_bins(P) * P * chunk_c(P) * 2 <= \
            BWD["kMaxSlotBytes"]
        assert part_bins(P) * P <= BWD["kMaxCopyRows"]
    for P in (7, 14):
        assert 2 * smem_bytes(P) <= KERNEL["kMaxSmem"]
        assert part_bins(P) == P


def test_k5_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks a CUDA call goes through, on meta tensors: the kernel
    takes bf16 d pooled, C a multiple of 8 up to 256, P up to 32, and
    fewer than 2^31 rows of d pooled (its tensor copies' coordinate); any
    level side."""
    def args(B=2, R=16, P=7, C=256, side=800, dtype=torch.bfloat16):
        shapes = [(B, side // 2 ** k, side // 2 ** k, C) for k in range(4)]
        return (torch.empty((B, R, P, P, C), dtype=dtype, device="meta"),
                shapes,
                torch.empty((B, R, 4), device="meta"),
                torch.empty((B, R), dtype=torch.int32, device="meta"), P, 0,
                torch.bfloat16)

    _check(*args())
    _check(*args(P=32, side=4096))
    with pytest.raises(ValueError):
        _check(*args(dtype=torch.float32))
    with pytest.raises(ValueError):
        _check(*args(C=12))
    with pytest.raises(ValueError):
        _check(*args(P=33))
    with pytest.raises(ValueError, match="2\\^31"):
        _check(*args(B=64, R=32768, P=32, C=8))
