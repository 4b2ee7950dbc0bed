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
its ranges exact (every non-zero weight inside them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadsurf_tpu.ops.roi_align import roi_align_multilevel as j_pool
from roadsurf_tpu_torch.ops import roi_align as tra
from roadsurf_tpu_torch.ops.roi_align_backward_kernel import \
    roi_align_backward, roi_align_backward_ref, smem_bytes
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
# numpy mirrors of K5 (csrc/roi_align_backward.cu)

f32 = np.float32


def _tap_span(lo, hi, inv, dim):
    """roi_align_staged.cuh::tap_span in float32."""
    last = f32(dim - 1)
    a = np.floor(f32(min(lo, hi)) * f32(inv) - f32(0.5)) - f32(1)
    b = np.floor(f32(max(lo, hi)) * f32(inv) - f32(0.5)) + f32(2)
    return int(min(max(a, 0), last)), int(min(max(b, 0), last))


def _bin_start(lo, binsz, p):
    return f32(f32(lo) + f32(f32(p) * f32(binsz)))


def _ranges(lo, hi, P, stride, dim):
    """K5's tap span of a box along one axis and each bin's evaluated
    cells (fill_weights: from the bin's own span, at most ceil(|bin| /
    stride) + 5 of them)."""
    binsz = f32(f32(f32(hi) - f32(lo)) / f32(P))
    inv = f32(1.0) / f32(stride)
    s0, s1 = _tap_span(_bin_start(lo, binsz, 0), _bin_start(lo, binsz, P),
                       inv, dim)
    n = s1 - s0 + 1
    span = min(n, int(np.ceil(f32(abs(binsz)) * inv)) + 5)
    cells = []
    for p in range(P):
        t0, t1 = _tap_span(_bin_start(lo, binsz, p),
                           _bin_start(lo, binsz, p + 1), inv, dim)
        c0 = max(t0, s0)
        cells.append((c0, min(c0 + span - 1, t1, s1)))
    return (s0, s1), cells


def _mirror(dout, boxes, lvl, P, s, shapes):
    """K5's sums: per box, per column x of its region, t[p] = Σ_q wx[q, x]
    dP[p, q] over the bins that weigh x, then per row y the add of Σ_p
    wy[p, y] t[p] over the bins that weigh y; weights only inside the
    ranges of :func:`_ranges` (the others are never evaluated)."""
    grads = [np.zeros(sh, np.float64) for sh in shapes]
    metas = tuple(torch.empty(sh, device="meta") for sh in shapes)
    for b in range(boxes.shape[0]):
        ws = axis_weights(tuple(m[b:b + 1] for m in metas),
                          torch.from_numpy(boxes[b:b + 1]),
                          torch.from_numpy(lvl[b:b + 1]), P, s, 2)
        for r in range(boxes.shape[1]):
            l = int(lvl[b, r])
            H, W = shapes[l][1:3]
            st = 2 ** (2 + l)
            x0, y0, x1, y1 = boxes[b, r]
            _, xc = _ranges(x0, x1, P, st, W)
            _, yc = _ranges(y0, y1, P, st, H)
            wy = ws[l][0][0, r].numpy()
            wx = ws[l][1][0, r].numpy()
            wxm = np.zeros_like(wx)
            wym = np.zeros_like(wy)
            for p in range(P):
                wxm[p, xc[p][0]:xc[p][1] + 1] = wx[p, xc[p][0]:xc[p][1] + 1]
                wym[p, yc[p][0]:yc[p][1] + 1] = wy[p, yc[p][0]:yc[p][1] + 1]
            # the weights outside the evaluated cells are all zero
            np.testing.assert_array_equal(wxm, wx)
            np.testing.assert_array_equal(wym, wy)
            xa = [np.flatnonzero(wx[q]) for q in range(P)]
            ya = [np.flatnonzero(wy[p]) for p in range(P)]
            xs = [(a[0], a[-1]) if len(a) else (1 << 30, -1) for a in xa]
            ys = [(a[0], a[-1]) if len(a) else (1 << 30, -1) for a in ya]
            rx0, rx1 = min(a for a, _ in xs), max(b_ for _, b_ in xs)
            ry0, ry1 = min(a for a, _ in ys), max(b_ for _, b_ in ys)
            g = dout[b, r].astype(np.float64)                 # (P, P, C)
            for x in range(rx0, rx1 + 1):
                t = np.zeros((P, g.shape[-1]))
                for q in range(P):
                    if xs[q][0] <= x <= xs[q][1]:
                        t += wx[q, x] * g[:, q]
                for y in range(ry0, ry1 + 1):
                    v = np.zeros(g.shape[-1])
                    for p in range(P):
                        if ys[p][0] <= y <= ys[p][1]:
                            v += wy[p, y] * t[p]
                    grads[l][b, y, x] += v
    return grads


@pytest.mark.parametrize("P,sampling", [(7, 2), (14, 0)])
def test_k5_mirror_ranges_and_sums(P, sampling):
    feats, boxes, rng = _inputs(20, seed=2)
    shapes = [x.shape for x in feats]
    bx = torch.from_numpy(boxes)
    lvl = tra.level_assignment(bx, 224, 4, 2, 5).contiguous().numpy()
    dout = rng.normal(size=(B, 20, P, P, C)).astype(np.float32)
    ref = roi_align_backward_ref(torch.from_numpy(dout), shapes, bx,
                                 torch.from_numpy(lvl), P, sampling)
    got = _mirror(dout, boxes, lvl, P, sampling, shapes)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5)
    assert set(lvl.flatten().tolist()) == {0, 1, 2, 3}


def test_k5_takes_the_training_shapes():
    """Its block's weight tables fit at 800 px (P2 side 200) for both
    poolers, and at the largest side the kernel's pooler forward takes."""
    for P in (7, 14):
        assert smem_bytes(P, 200) <= KERNEL["kMaxSmem"]
    assert smem_bytes(32, 800) <= KERNEL["kMaxSmem"]
