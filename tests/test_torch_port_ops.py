"""CPU parity of the PyTorch port's ops against the JAX package.

Same inputs, made from numpy seeds, go through the JAX function and its
counterpart in ``roadsurf_tpu_torch``. Where the reference is exact
(anchors, top-k order, NMS keep sets, proposal selection) the port must be
exact; the pooler is held at a stated tolerance.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadsurf_tpu.models import anchors as janchors
from roadsurf_tpu.models import fast_profile
from roadsurf_tpu.models import rpn as jrpn
from roadsurf_tpu.ops import nms as jnms
from roadsurf_tpu.ops.roi_align import roi_align_multilevel as j_roi_align
from roadsurf_tpu_torch.models import anchors as tanchors
from roadsurf_tpu_torch.models import rpn as trpn
from roadsurf_tpu_torch.ops import nms as tnms
from roadsurf_tpu_torch.ops.roi_align import roi_align_multilevel, \
    roi_align_multilevel_ref
from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused

torch.set_num_threads(1)

NEG_INF = tnms.NEG_INF
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "op_goldens.npz")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# anchors and box math

@pytest.mark.parametrize("S", [64, 256, 800])
def test_anchors_exactly_equal(S):
    cfg = fast_profile()
    ref = janchors.all_level_anchors(S, cfg.fpn_strides, cfg.anchor_sizes,
                                     cfg.anchor_aspect_ratios)
    got = tanchors.all_level_anchors(S, cfg.fpn_strides, cfg.anchor_sizes,
                                     cfg.anchor_aspect_ratios)
    assert len(got) == len(ref)
    if S == 800:
        # the parity profile's levels: P2..P5 at 200..25, P6 at 13x13
        assert [len(g) for g in got] == [3 * s * s
                                         for s in (200, 100, 50, 25, 13)]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_apply_deltas_and_clip_match():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 200, (50, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(1, 60, (50, 2))
    deltas = rng.normal(0, 1.5, (50, 4)).astype(np.float32)
    deltas[0, 2:] = 9.0                       # past SCALE_CLAMP
    for w in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        ref = np.asarray(janchors.clip_boxes(
            janchors.apply_deltas(jnp.asarray(deltas), jnp.asarray(boxes), w),
            128, 160))
        got = tanchors.clip_boxes(
            tanchors.apply_deltas(_t(deltas), _t(boxes), w), 128, 160).numpy()
        # exp differs between the two CPU libraries by a few ulps
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------------------
# top-k and NMS: exact

def test_top_k_breaks_ties_toward_lower_index():
    rng = np.random.default_rng(1)
    x = np.round(rng.uniform(0, 1, (3, 200)), 1).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.3] = NEG_INF
    for k in (1, 17, 200):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tnms.top_k(_t(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def _nms_cases():
    """Adversarial inputs: a staircase chain (greedy keeps every other box,
    a single sweep over-suppresses), clusters with score ties and NEG_INF
    padding, exact duplicates, zero-area boxes."""
    n = 24
    stair = np.stack([np.arange(n) * 6.0, np.zeros(n),
                      np.arange(n) * 6.0 + 10.0, np.full(n, 10.0)],
                     1).astype(np.float32)
    cases = [(stair, np.linspace(1.0, 0.5, n).astype(np.float32), 0.3),
             (stair, np.full(n, 0.5, np.float32), 0.3)]
    rng = np.random.default_rng(17)
    for trial in range(4):
        m = 120
        centers = rng.uniform(0, 80, (10, 2))
        c = centers[rng.integers(0, 10, m)] + rng.normal(0, 4, (m, 2))
        wh2 = rng.uniform(4, 14, (m, 2))
        b = np.concatenate([c - wh2, c + wh2], 1).astype(np.float32)
        b[5] = b[4]                                   # exact duplicate
        b[7, 2:] = b[7, :2]                           # zero area
        s = np.round(rng.uniform(0, 1, m), 2).astype(np.float32)  # ties
        s[rng.uniform(size=m) < 0.2] = NEG_INF                    # padding
        cases.append((b, s, 0.5 if trial % 2 else 0.7))
    return cases


@pytest.mark.parametrize("fn", ["nms_sweep", "nms_fixed"])
def test_nms_keep_indices_exactly_equal(fn):
    for b, s, t in _nms_cases():
        for max_out in (len(b), 10):
            rs, ri = getattr(jnms, fn)(jnp.asarray(b), jnp.asarray(s), t,
                                       max_out)
            gs, gi = getattr(tnms, fn)(_t(b), _t(s), t, max_out)
            np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
            np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("case", range(6))
def test_nms_scan_is_the_oracle_of_nms_fixed_and_k3(case):
    """``nms_scan``, the textbook rank scan, equals the reference's; the
    port's ``nms_fixed`` and K3's plain version (on the stably sorted
    boxes, its keep mask scattered back) keep exactly what it keeps, in its
    order, ties and NEG_INF padding in the input included. The slots past
    the kept boxes hold NEG_INF in all three; their indices differ by
    design (the scan's in rank order, ``nms_fixed``'s in input order)."""
    from roadsurf_tpu_torch.ops.nms_kernel import nms_keep_mask_ref

    b, s, t = _nms_cases()[case]
    for max_out in (len(b), 10):
        rs, ri = jnms.nms_scan(jnp.asarray(b), jnp.asarray(s), t, max_out)
        gs, gi = tnms.nms_scan(_t(b), _t(s), t, max_out)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        kept = gs > NEG_INF / 2
        assert 0 < int(kept.sum()) <= max_out
        fs, fi = tnms.nms_fixed(_t(b), _t(s), t, max_out)
        np.testing.assert_array_equal(fs.numpy(), gs.numpy())
        np.testing.assert_array_equal(fi[kept].numpy(), gi[kept].numpy())
        order = torch.sort(_t(s), descending=True, stable=True).indices
        keep = nms_keep_mask_ref(_t(b)[order], _t(s)[order], t)
        ks, ki = tnms._kept_top(
            torch.zeros_like(keep).scatter_(0, order, keep), _t(s), max_out)
        np.testing.assert_array_equal(ks.numpy(), gs.numpy())
        np.testing.assert_array_equal(ki[kept].numpy(), gi[kept].numpy())


@pytest.mark.parametrize("fast", [True, False])
def test_batched_nms_exactly_equal_with_batch_dim(fast):
    """The port's NMS takes a leading batch dim where the reference
    vmaps; class offsets keep classes apart."""
    cases = [c for c in _nms_cases() if len(c[0]) == 120]
    b = np.stack([c[0] for c in cases])
    s = np.stack([c[1] for c in cases])
    cls = np.random.default_rng(2).integers(0, 3, s.shape).astype(np.int32)
    ref = jax.vmap(lambda bb, ss, cc: jnms.batched_nms_fixed(
        bb, ss, cc, 0.5, 40, fast=fast))(jnp.asarray(b), jnp.asarray(s),
                                         jnp.asarray(cls))
    gs, gi = tnms.batched_nms_fixed(_t(b), _t(s), _t(cls), 0.5, 40,
                                    fast=fast)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ref[1]))


def test_nms_fixed_matches_golden_keep():
    from golden.make_golden import case_nms

    b, s, t = case_nms()
    gold = np.load(GOLDEN)["nms_keep"]
    ks, ki = tnms.nms_fixed(_t(b), _t(s), t, len(b))
    mine = ki.numpy()[ks.numpy() > NEG_INF / 2]
    np.testing.assert_array_equal(mine, gold)


# ---------------------------------------------------------------------------
# RPN: local-max gate and proposal selection, exact in f32

def _rpn_inputs(S, B, seed, zero_deltas):
    cfg = fast_profile(post_nms_topk=32)
    anchors = janchors.all_level_anchors(S, cfg.fpn_strides, cfg.anchor_sizes,
                                         cfg.anchor_aspect_ratios)
    gate_geom = [(cfg.num_anchors, cfg.anchor_aspect_ratios, st, sz)
                 for st, sz in zip(cfg.fpn_strides, cfg.anchor_sizes)]
    rng = np.random.default_rng(seed)
    # quantized scores: equal-score neighbor chains and cross-level ties
    logits = [(np.round(rng.normal(size=(B, a.shape[0])) * 4) / 4)
              .astype(np.float32) for a in anchors]
    deltas = [np.zeros((B, a.shape[0], 4), np.float32) if zero_deltas
              else rng.normal(0, 0.3, (B, a.shape[0], 4)).astype(np.float32)
              for a in anchors]
    return cfg, anchors, gate_geom, logits, deltas


def test_local_max_gate_exactly_equal():
    cfg, anchors, gate_geom, logits, _ = _rpn_inputs(64, 3, 7, True)
    for lg, geom in zip(logits, gate_geom):
        ref = np.asarray(jrpn._local_max_gate(jnp.asarray(lg), *geom,
                                              cfg.rpn_nms_thresh))
        got = trpn._local_max_gate(_t(lg), *geom, cfg.rpn_nms_thresh)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fast_nms,gate,zero_deltas", [
    (True, True, True), (True, True, False), (True, False, False),
    (False, False, False)])
def test_select_proposals_match(fast_nms, gate, zero_deltas):
    """Scores are gathered logits, so equal scores mean equal selections;
    with zero deltas the boxes are the anchors and must be equal too. With
    random deltas the boxes carry the exp's ulp differences."""
    S, B = 64, 2
    cfg, anchors, gate_geom, logits, deltas = _rpn_inputs(S, B, 11,
                                                          zero_deltas)
    pre, post = cfg.rpn_pre_nms_topk_test, cfg.rpn_post_nms_topk_test
    rb, rs = jax.jit(lambda lg, dl: jrpn.select_proposals(
        lg, dl, anchors, S, pre, post, cfg.rpn_nms_thresh, fast_nms=fast_nms,
        local_max_gate=gate, gate_geom=gate_geom))(logits, deltas)
    gb, gs = trpn.select_proposals(
        [_t(x) for x in logits], [_t(x) for x in deltas], anchors, S, pre,
        post, cfg.rpn_nms_thresh, fast_nms=fast_nms, local_max_gate=gate,
        gate_geom=gate_geom)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    if zero_deltas:
        np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    else:
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=1e-6,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# RoIAlign: the kernel's plain version against the JAX poolers

def _pool_inputs(B, R, C, S, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, S // st, S // st, C)).astype(dtype)
             for st in (4, 8, 16, 32)]
    x0 = rng.uniform(-10, S - 10, (B, R))
    y0 = rng.uniform(-10, S - 10, (B, R))
    w = rng.uniform(2, S, (B, R))
    h = rng.uniform(2, S, (B, R))
    boxes = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)
    boxes[0, 0] = [0.0, 0.0, 0.0, 0.0]                 # padded zero box
    boxes[0, 1] = [S - 8.0, 5.0, S - 8.0, 30.0]         # zero area
    boxes[0, 2] = [-30.0, -30.0, S + 30.0, S + 30.0]    # beyond borders
    boxes[1, 0] = [S - 2.0, S - 2.0, S + 40.0, S + 9.0]  # on the far edge
    boxes[1, 1] = [0.0, 0.0, S, S]                      # whole image
    return feats, boxes


@pytest.mark.parametrize("P", [7, 14])
def test_roi_align_plain_matches_jax_separable(P):
    """f32 plain version vs the reference's separable path at 256 px
    geometry (P2..P4 reachable), edge boxes included; the two sum the same
    f32 products in another order (atol 1e-5)."""
    feats, boxes = _pool_inputs(2, 8, 4, 256, 3)
    ref = np.asarray(j_roi_align([jnp.asarray(f) for f in feats],
                                 jnp.asarray(boxes), P, sampling=2))
    got = roi_align_multilevel_ref([_t(f) for f in feats], _t(boxes), P, 2)
    assert got.shape == (2, 8, P, P, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the dispatcher on CPU tensors runs the same plain version
    np.testing.assert_array_equal(
        roi_align_multilevel([_t(f) for f in feats], _t(boxes), P).numpy(),
        got.numpy())


@pytest.mark.parametrize("P", [7, 14])
def test_roi_align_plain_matches_jax_fused_kernel(P):
    """Plain version vs the TPU kernel itself in interpret mode, at the
    reference test's geometry (B=2, R=8, C=8, S=64). atol 2e-2: the kernel
    rounds its y-weights and its first contraction to bf16
    (roi_align_pallas.py:116,144)."""
    from roadsurf_tpu.ops.roi_align_pallas import roi_align_fused as jfused

    rng = np.random.default_rng(5)
    B, R, C, S = 2, 8, 8, 64
    feats = [np.asarray(jnp.asarray(rng.normal(size=(B, S // st, S // st, C)),
                                    jnp.bfloat16).astype(jnp.float32))
             for st in (4, 8, 16)]
    x0 = rng.uniform(0, 50, (B, R))
    y0 = rng.uniform(0, 50, (B, R))
    w = rng.uniform(4, 40, (B, R))
    h = rng.uniform(4, 40, (B, R))
    boxes = np.stack([x0, y0, np.minimum(x0 + w, S), np.minimum(y0 + h, S)],
                     -1).astype(np.float32)
    ref = np.asarray(jfused(tuple(jnp.asarray(f, jnp.bfloat16)
                                  for f in feats),
                            jnp.asarray(boxes), P, interpret=True),
                     np.float32)
    got = roi_align_multilevel_ref([_t(f) for f in feats], _t(boxes), P, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2)


def test_roi_align_plain_matches_golden():
    """Against the committed scalar-oracle golden (single level, stride 1:
    min_level 0)."""
    from golden.make_golden import case_roi_align_fixed

    feat, boxes, P, sr = case_roi_align_fixed()
    gold = np.load(GOLDEN)["roi_align_fixed"]
    got = roi_align_multilevel_ref([_t(feat[None])], _t(boxes[None]), P, sr,
                                   min_level=0)[0]
    np.testing.assert_allclose(got.numpy(), gold, atol=1e-5)


def test_roi_align_wrapper_on_cpu_runs_plain_version_in_feature_dtype():
    feats, boxes = _pool_inputs(2, 4, 4, 256, 9)
    fb = [_t(f).to(torch.bfloat16) for f in feats[:3]]
    lvl = torch.zeros((2, 4), dtype=torch.int32)
    before = roi_align_fused.launches
    out = roi_align_fused(tuple(fb), _t(boxes), lvl, 7, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 7, 7, 4)
    assert roi_align_fused.launches == before      # no kernel on the CPU
