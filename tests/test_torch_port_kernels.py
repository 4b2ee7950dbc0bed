"""CPU parity of the plain versions of the parity profile's kernels against
the JAX package: K2 (``roi_align_fused_blocked``, adaptive and fixed
sampling on large maps) and K3 (``nms_keep_mask``, the greedy keep mask).

Same inputs, made from numpy seeds, go through the JAX function and the
port's plain version. Tolerances, stated per test:
* adaptive axis weights: atol 1e-6 (the same closed-form series in f32);
* K2 plain vs the reference's separable path and the golden: atol 1e-5
  (the same f32 products summed in another order);
* K2 plain vs the TPU kernel in interpret mode: rtol 2^-7, atol 5e-3 (the
  TPU kernel rounds wy, wx and t1 to bf16);
* K3: exact, keep masks and keep indices.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roadsurf_tpu.ops import nms as jnms
from roadsurf_tpu.ops.roi_align import _axis_weights_adaptive_at as \
    j_adaptive_at
from roadsurf_tpu.ops.roi_align import _level_assignment as j_level
from roadsurf_tpu.ops.roi_align import _roi_align_separable as j_separable
from roadsurf_tpu_torch.ops import nms as tnms
from roadsurf_tpu_torch.ops.nms_kernel import nms_keep_mask, \
    nms_keep_mask_ref
from roadsurf_tpu_torch.ops.roi_align import level_assignment
from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
    roi_align_fused_blocked, roi_align_fused_blocked_ref
from roadsurf_tpu_torch.ops.roi_align_kernel import \
    _axis_weights_adaptive_at, bin_sizes

torch.set_num_threads(1)

NEG_INF = tnms.NEG_INF
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "op_goldens.npz")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# adaptive weights

def _adaptive_cases():
    """(lo, bin_size) rows (image px) along one axis, stride 4, dim 50,
    P 7: thin roads with n >= 29 samples a bin, zero-size bins, samples
    exactly at c = -1 and at c = dim, boxes beyond both borders, and
    random boxes."""
    s, dim, P = 4.0, 50, 7
    rows = [(0.0, 800.0 / 7), (3.0, 116.3),
            (17.0, 0.0), (0.0, 0.0), (199.0, 0.0),   # zero-size bins
            (-4.0, 4.0),          # bin 0's one sample exactly at c = -1
            (dim * s - 6 * s, 4.0),   # bin 6's one sample exactly at c = dim
            (-4.0, 8.0),          # bin 0's first of 2 samples at c = -1
            (-40.0, 30.0), (180.0, 9.0), (-300.0, 100.0)]
    rng = np.random.default_rng(4)
    for _ in range(20):
        rows.append((rng.uniform(-20, 190), rng.uniform(0.1, 40)))
    lo, bin_size = (np.asarray(c, np.float32)[None] for c in zip(*rows))
    return lo, bin_size, s, dim, P


def test_adaptive_weights_match_jax():
    lo, bin_size, s, dim, P = _adaptive_cases()
    n = np.maximum(np.ceil(bin_size / s), 1)
    assert n.max() >= 29                       # the thin road
    d = np.arange(-2, dim + 2, dtype=np.float32)
    ref = np.asarray(j_adaptive_at(jnp.asarray(lo), jnp.asarray(bin_size),
                                   jnp.asarray(d), dim, s, P))
    got = _axis_weights_adaptive_at(_t(lo), _t(bin_size), _t(d), dim, s, P)
    assert got.shape == ref.shape == (1, lo.shape[1], P, d.size)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    # a valid sample weighs 1 on its axis: rows sum to the valid share
    inside = got.numpy()[..., 2:-2]
    assert np.all(inside >= 0) and np.all(inside.sum(-1) <= 1 + 1e-5)
    # c = -1 and c = dim are valid and land on the edge cells in full
    np.testing.assert_allclose(inside[0, 5, 0, 0], 1.0, atol=1e-6)
    np.testing.assert_allclose(inside[0, 6, 6, dim - 1], 1.0, atol=1e-6)
    np.testing.assert_allclose(inside[0, 7, 0, 0], 1.0, atol=1e-6)
    # zero-size bins keep their one sample (no NaN from delta = 0)
    assert np.isfinite(inside).all()
    np.testing.assert_allclose(inside[0, 2:5].sum(-1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# K2's plain version

def _blocked_inputs(B, R, C, S, seed):
    """4 levels at S px (S = 352: W = 88/44/22/11, not powers of two) and
    the reference's adversarial road boxes (tests/test_model.py:636-638)
    first in every image, random ones after."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, S // 2 ** l, S // 2 ** l, C))
             .astype(np.float32) for l in range(2, 6)]
    special = [[0.0, 0.0, S, S], [0.0, 100.0, S, 106.0],
               [40.0, 0.0, 43.0, S], [0.0, 0.0, 2.0, 2.0],
               [5.0, 5.0, 5.6, 6.1], [0.0, 0.0, S, 9.0],
               [0.0, 0.0, 0.0, 0.0], [-30.0, 20.0, S + 40.0, 60.0],
               [-100.0, -100.0, S + 100.0, S + 100.0]]      # P5
    boxes = []
    for _ in range(B):
        bs = list(special[:R])
        while len(bs) < R:
            x0, y0 = rng.uniform(0, S - 2, 2)
            bs.append([x0, y0, min(S, x0 + rng.uniform(0.5, S / 2)),
                       min(S, y0 + rng.uniform(0.5, S / 2))])
        boxes.append(bs)
    return feats, np.asarray(boxes, np.float32)


@pytest.mark.parametrize("P,sampling", [(7, 0), (14, 0), (7, 2)])
def test_blocked_plain_matches_jax_separable(P, sampling):
    feats, boxes = _blocked_inputs(2, 24, 8, 352, 3)
    jl = j_level(jnp.asarray(boxes), 224, 4, 2, 5)
    lvl = level_assignment(_t(boxes), 224, 4, 2, 5)
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(jl))
    assert set(np.unique(lvl.numpy())) == {0, 1, 2, 3}
    ref = np.asarray(j_separable([jnp.asarray(f) for f in feats],
                                 jnp.asarray(boxes), jl, P, sampling, 2))
    got = roi_align_fused_blocked_ref([_t(f) for f in feats], _t(boxes),
                                      lvl.contiguous(), P, sampling)
    assert got.shape == (2, 24, P, P, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the wrapper on CPU tensors runs the plain version, without a launch
    before = roi_align_fused_blocked.launches
    out = roi_align_fused_blocked(tuple(_t(f) for f in feats), _t(boxes),
                                  lvl.contiguous(), P, sampling)
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    assert roi_align_fused_blocked.launches == before


def test_blocked_plain_matches_golden_adaptive():
    """Against the committed scalar-oracle golden (single level, stride 1:
    min_level 0, adaptive sampling)."""
    from golden.make_golden import case_roi_align_adaptive

    feat, boxes, P, sr = case_roi_align_adaptive()
    assert sr == 0
    gold = np.load(GOLDEN)["roi_align_adaptive"]
    got = roi_align_fused_blocked_ref(
        (_t(feat[None]),), _t(boxes[None]),
        torch.zeros((1, len(boxes)), dtype=torch.int32), P, 0,
        min_level=0)[0]
    np.testing.assert_allclose(got.numpy(), gold, atol=1e-5)


def test_blocked_plain_matches_jax_tpu_kernel_interpreted():
    """The TPU kernel itself in interpret mode (B=1, R=16, C=8, S=352,
    adaptive): its wy, wx and t1 are rounded to bf16, three roundings of
    at most 2^-9 each, so rtol 2^-7 beside the reference test's atol 5e-3
    (tests/test_model.py:655), which alone does not hold where small
    boxes pool values near 2."""
    from roadsurf_tpu.ops.roi_align_pallas import \
        roi_align_fused_blocked as j_blocked

    feats, boxes = _blocked_inputs(1, 16, 8, 352, 5)
    fb = [np.asarray(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32))
          for f in feats]
    ref = np.asarray(j_blocked(tuple(jnp.asarray(f, jnp.bfloat16)
                                     for f in fb), jnp.asarray(boxes), 7,
                               sampling=0, interpret=True,
                               out_dtype=jnp.float32))
    lvl = level_assignment(_t(boxes), 224, 4, 2, 5).contiguous()
    got = roi_align_fused_blocked_ref([_t(f) for f in fb], _t(boxes), lvl,
                                      7, 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2 ** -7, atol=5e-3)


def test_bin_sizes_divide_exactly():
    """The bin sizes the kernels receive: (x1 - x0) / P correctly rounded
    (a product with a rounded 1/P would differ in the last place)."""
    rng = np.random.default_rng(8)
    b = rng.uniform(-50, 900, (3, 500, 4)).astype(np.float32)
    for P in (7, 14):
        _, _, bw, bh = bin_sizes(_t(b), P)
        np.testing.assert_array_equal(bw.numpy(),
                                      (b[..., 2] - b[..., 0]) / np.float32(P))
        np.testing.assert_array_equal(bh.numpy(),
                                      (b[..., 3] - b[..., 1]) / np.float32(P))


# ---------------------------------------------------------------------------
# K3's plain version

def _sorted(b, s):
    order = np.argsort(-s, kind="stable")
    return b[order], s[order], order


def _keep_cases():
    """Boxes with no pair's IoU within 1e-5 of the threshold (the TPU
    kernel divides, the port does not); a staircase chain; clusters with
    tied scores, duplicates, zero areas and NEG_INF padding."""
    rng = np.random.default_rng(12)
    cases = []
    for trial in range(3):
        b = rng.uniform(0, 100, (60, 4)).astype(np.float32)
        b = np.concatenate([np.minimum(b[:, :2], b[:, 2:]),
                            np.maximum(b[:, :2], b[:, 2:]) + 3], 1)
        s = rng.uniform(0, 1, 60).astype(np.float32)
        if trial == 2:
            s = np.round(s, 1)                          # ties
            s[rng.uniform(size=60) < 0.25] = NEG_INF    # padding
        cases.append((b, s, 0.5))
    n = 30
    stair = np.stack([np.arange(n) * 6.0, np.zeros(n),
                      np.arange(n) * 6.0 + 10.0, np.full(n, 10.0)],
                     1).astype(np.float32)
    # neighbours overlap at IoU 0.25, boxes two apart not at all
    cases.append((stair, np.linspace(1.0, 0.5, n).astype(np.float32), 0.2))
    cases.append((stair, np.full(n, 0.5, np.float32), 0.2))
    return cases


def _iou(b):
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1).astype(np.float64)
    area = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    return inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-12)


def test_keep_mask_plain_matches_jax_tpu_kernel_interpreted():
    from roadsurf_tpu.ops.nms_pallas import nms_keep_mask as j_keep

    cases = [c for c in _keep_cases() if len(c[0]) == 60]
    for b, _, t in cases:
        assert np.abs(_iou(b) - t).min() > 1e-5
    sb, ss = zip(*[_sorted(b, s)[:2] for b, s, _ in cases])
    sb, ss = np.stack(sb), np.stack(ss)
    ref = np.asarray(j_keep(jnp.asarray(sb), jnp.asarray(ss > NEG_INF / 2),
                            0.5, interpret=True))
    got = nms_keep_mask_ref(_t(sb), _t(ss), 0.5)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    # the wrapper on CPU tensors runs the plain version
    before = nms_keep_mask.launches
    np.testing.assert_array_equal(nms_keep_mask(_t(sb), _t(ss), 0.5).numpy(),
                                  ref)
    assert nms_keep_mask.launches == before


def test_sorted_keep_matches_jax_nms_fixed():
    """The route of exact NMS (stable sort, keep mask, scatter back), on
    CPU tensors with the keep mask's plain version, against the
    reference's nms_fixed, on chains (A kills B, B would kill C), ties
    (the lower index wins), duplicates and padding; and a batch of
    problems in one call."""
    cases = _keep_cases()
    for b, s, t in cases:
        rs, ri = jnms.nms_fixed(jnp.asarray(b), jnp.asarray(s), t, len(b))
        gs, gi = tnms.nms_fixed(_t(b), _t(s), t, len(b))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    stair, s_tie = cases[-1][0], cases[-1][1]
    # equal scores: the staircase keeps every other box from index 0
    np.testing.assert_array_equal(
        tnms.keep_sorted(_t(stair), _t(s_tie), 0.2).numpy(),
        np.arange(len(stair)) % 2 == 0)
    b = np.stack([c[0] for c in cases[:3]])
    s = np.stack([c[1] for c in cases[:3]])
    s[1] = NEG_INF                                 # an all-padded problem
    kb = tnms.keep_sorted(_t(b), _t(s), 0.5)
    assert not kb[1].any()
    for i in (0, 2):
        np.testing.assert_array_equal(
            kb[i].numpy(), tnms.keep_sorted(_t(b[i]), _t(s[i]), 0.5).numpy())


def test_keep_mask_plain_matches_golden():
    from golden.make_golden import case_nms

    b, s, t = case_nms()
    gold = np.load(GOLDEN)["nms_keep"]
    sb, ss, order = _sorted(b, s)
    keep = nms_keep_mask_ref(_t(sb), _t(ss), t).numpy()
    np.testing.assert_array_equal(order[keep], gold)
