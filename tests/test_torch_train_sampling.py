"""The training engine's matching, sampling, losses, mask targets, learning
rate schedule and freezing rule in the PyTorch port against the JAX
package's ``engine/train.py``, on the CPU.

The samplers draw with ``jax.random`` in the reference; the port takes its
uniforms as inputs, so each test draws them here from the reference's key
tree (``subsample``: ``split(key)`` into the positive and negative
priorities; ``gather_topk_mask``: one ``uniform`` of the mask's length) and
feeds the same values to both.

Tolerances: matching, sampling, ``gather_topk_mask`` and
``crop_mask_targets`` exact (the same f32 operations in the same order,
ties to the lower index); the losses atol 1e-6; ``lr_schedule`` rtol 1e-6;
``_is_frozen`` equal leaf for leaf.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadsurf_tpu.engine import train as jt
from roadsurf_tpu.models.anchors import all_level_anchors as j_anchors
from roadsurf_tpu.models.config import ModelConfig as JConfig
from roadsurf_tpu.models.mask_rcnn import init_params as j_init_params
from roadsurf_tpu_torch.engine import train as tt
from roadsurf_tpu_torch.models.config import ModelConfig
from roadsurf_tpu_torch.utils.weights import from_jax_train_params

torch.set_num_threads(1)


def _gt(rng, B: int, G: int, S: int, n_valid):
    """Padded GT: boxes of 6..40 px inside an S px tile, the first
    ``n_valid[b]`` valid, a duplicate box (IoU ties) in image 0, zero
    padding rows."""
    boxes = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        for g in range(n_valid[b]):
            x0, y0 = rng.uniform(0, S - 40, 2)
            w, h = rng.uniform(6, 40, 2)
            boxes[b, g] = (x0, y0, x0 + w, y0 + h)
            valid[b, g] = True
    if n_valid[0] >= 2:
        boxes[0, 1] = boxes[0, 0]
    return boxes, valid


def _anchors(S: int) -> np.ndarray:
    cfg = JConfig()
    return np.concatenate(j_anchors(S, cfg.fpn_strides, cfg.anchor_sizes,
                                    cfg.anchor_aspect_ratios,
                                    cfg.anchor_offset), axis=0)


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_to_gt_is_exact(low_quality):
    rng = np.random.default_rng(0)
    S, B, G = 64, 3, 5
    boxes, valid = _gt(rng, B, G, S, (3, 1, 0))
    anchors = _anchors(S)
    boxes[1, 0] = anchors[200]          # a GT box on an anchor: IoU 1
    thr = (0.3, 0.7)
    ref = jax.vmap(lambda g, v: jt.match_to_gt(
        jnp.asarray(anchors), g, v, thr, allow_low_quality=low_quality))(
        jnp.asarray(boxes), jnp.asarray(valid))
    got = tt.match_to_gt(torch.from_numpy(anchors), torch.from_numpy(boxes),
                         torch.from_numpy(valid), thr,
                         allow_low_quality=low_quality)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    # every label occurs; the image without valid GT is all background
    assert set(np.unique(got[1].numpy())) == {-1, 0, 1}
    assert (got[1][2] == 0).all()


def _subsample_draws(keys, n: int):
    pos, neg = [], []
    for k in keys:
        kp, kn = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(kp, (n,))))
        neg.append(np.asarray(jax.random.uniform(kn, (n,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


@pytest.mark.parametrize("num,frac", [(16, 0.5), (64, 0.25), (1024, 0.5)])
def test_subsample_and_gather_are_exact(num, frac):
    """RPN-like (16 of 1023, quota 8), ROI-like (64, 25% positives) and a
    quota above the candidates' count; then the pick of the selected ones
    in priority order (``gather_topk_mask``), ties to the lower index."""
    rng = np.random.default_rng(1)
    S, B, G = 64, 3, 5
    boxes, valid = _gt(rng, B, G, S, (4, 2, 0))
    anchors = _anchors(S)
    _, label = jax.vmap(lambda g, v: jt.match_to_gt(
        jnp.asarray(anchors), g, v, (0.3, 0.7), allow_low_quality=True))(
        jnp.asarray(boxes), jnp.asarray(valid))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    ref = jax.vmap(lambda lb, k: jt.subsample(lb, num, frac, k))(label, keys)
    pos_u, neg_u = _subsample_draws(keys, label.shape[1])
    lab = torch.from_numpy(np.array(label)).long()
    got = tt.subsample(lab, num, frac, pos_u, neg_u)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[0].sum() + got[1].sum()) <= B * num

    sel = np.asarray(ref[0]) | np.asarray(ref[1])
    k = min(num, label.shape[1])
    pk = jax.random.split(jax.random.PRNGKey(9), B)
    ref_idx, ref_valid = jax.vmap(lambda m, kk: jt.gather_topk_mask(
        m, kk, k))(jnp.asarray(sel), pk)
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        kk, (label.shape[1],))) for kk in pk]))
    idx, ok = tt.gather_topk_mask(torch.from_numpy(sel), u, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_valid))


def test_rank_breaks_ties_to_the_lower_index():
    """Equal priorities rank in index order, as the reference's stable
    ``jnp.argsort``; entries outside the mask rank n."""
    u = torch.tensor([[0.5, 0.25, 0.5, 0.25, 0.9, 0.5]])
    mask = torch.tensor([[True, True, True, True, False, True]])
    r = jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(u.numpy()), 2.0)
    order = jnp.argsort(r[0])
    ref = np.zeros(6, np.int64)
    ref[np.asarray(order)] = np.arange(6)
    ref = np.where(mask.numpy()[0], ref, 6)
    np.testing.assert_array_equal(tt._rank(mask, u).numpy()[0], ref)
    np.testing.assert_array_equal(ref, [2, 0, 3, 1, 6, 4])


@pytest.mark.parametrize("beta", [0.0, 1.0 / 9])
def test_losses_match(beta):
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(4, 50, 4)).astype(np.float32)
    tgt = (pred + rng.normal(scale=0.3, size=pred.shape)).astype(np.float32)
    np.testing.assert_allclose(
        tt.smooth_l1(torch.from_numpy(pred), torch.from_numpy(tgt),
                     beta).numpy(),
        np.asarray(jt.smooth_l1(pred, tgt, beta)), atol=1e-6)
    logits = rng.normal(scale=4.0, size=(4, 300)).astype(np.float32)
    targets = (rng.random((4, 300)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tt.bce_with_logits(torch.from_numpy(logits),
                           torch.from_numpy(targets)).numpy(),
        np.asarray(jt.bce_with_logits(logits, targets)), atol=1e-6)
    cl = rng.normal(scale=3.0, size=(4, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (4, 64)).astype(np.int32)
    np.testing.assert_allclose(
        tt.softmax_ce(torch.from_numpy(cl), torch.from_numpy(labels),
                      3).numpy(),
        np.asarray(jt.softmax_ce(cl, labels, 3)), atol=1e-6)


def test_crop_mask_targets_is_exact():
    """ROIs inside, across and beyond the tile, a zero box, boxes whose
    samples fall on pixel centres and a NaN box (a diverged step: the
    reference's gather clamps its indices); the port's in-place form
    (``owner``: the bitmap of each ROI) equals its gathered form."""
    rng = np.random.default_rng(4)
    S, N, M, out = 64, 3, 13, 28
    masks = (rng.random((N, S, S)) < 0.4).astype(np.uint8)
    boxes = np.concatenate([
        np.sort(rng.uniform(-10, S + 10, (M - 5, 2, 2)), axis=1)
        .transpose(0, 2, 1).reshape(M - 5, 4)[:, [0, 2, 1, 3]],
        np.asarray([[0, 0, 0, 0], [0, 0, S, S], [3.5, 7.5, 31.5, 35.5],
                    [S - 1, S - 1, S + 5, S + 5],
                    [np.nan] * 4])]).astype(np.float32)
    owner = rng.integers(0, N, M)
    ref = np.asarray(jt.crop_mask_targets(
        jnp.asarray(masks[owner].astype(np.float32)), jnp.asarray(boxes),
        out))
    gathered = tt.crop_mask_targets(torch.from_numpy(masks[owner]).float(),
                                    torch.from_numpy(boxes), out)
    in_place = tt.crop_mask_targets(torch.from_numpy(masks),
                                    torch.from_numpy(boxes), out,
                                    torch.from_numpy(owner))
    np.testing.assert_array_equal(gathered.numpy(), ref)
    np.testing.assert_array_equal(in_place.numpy(), ref)
    assert 0 < ref.mean() < 1


def test_lr_schedule_matches():
    cfg, jcfg = ModelConfig(), JConfig()
    steps = {0, 1, 199, 200, 12000}
    for m in cfg.steps:
        steps |= {m - 1, m, m + 1}
    for s in sorted(steps):
        ref = float(jt.lr_schedule(jnp.asarray(s, jnp.int32), jcfg))
        assert tt.lr_schedule(s, cfg) == pytest.approx(ref, rel=1e-6), s
    assert len(cfg.steps) == 16


@pytest.mark.parametrize("freeze_at", [0, 1, 2])
def test_is_frozen_over_the_whole_tree(freeze_at):
    """The reference's decision for every leaf of its parameter tree, and
    the port's train state holds exactly those leaves."""
    cfg = JConfig()
    tree = jax.eval_shape(lambda k: j_init_params(k, cfg),
                          jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    ref = {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path):
           jt._is_frozen(path, freeze_at) for path, _ in flat}
    got = {path: tt._is_frozen(path, freeze_at) for path in ref}
    assert got == ref
    frozen = sum(ref.values())
    assert 0 < frozen < len(ref)
    # the port's train state has the same leaves (the units unfolded)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    port = from_jax_train_params(zeros)
    assert {p for p, _ in tt.leaves(port)} == set(ref)
