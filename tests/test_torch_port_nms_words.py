"""K3's two phases, as the card runs them, against the JAX package on the
CPU: the plain mirrors of the kernel's pair phase
(``suppression_words``: 64-bit suppression words, upper triangle only)
and of its sweep (``sweep_words``: 64 ranks at a time from those words),
held exactly equal to the port's Jacobi plain version and to the
reference's TPU kernel ``nms_keep_mask`` in interpret mode.

The TPU kernel tests ``inter / union > t`` and the port ``inter >
t·union``; the boxes here have integer corners and sides under 30, so
every IoU is a fraction with a denominator under 2·30², and one that is
not exactly t lies more than 1e-6 from it: both tests decide every pair
alike (checked per case).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roadsurf_tpu.ops.nms_pallas import nms_keep_mask as j_keep
from roadsurf_tpu_torch.ops.nms_kernel import NEG_INF, WORD, \
    nms_keep_mask_ref, row_words, suppression_words, sweep_words

torch.set_num_threads(1)


def _clusters(rng, P, N, span=100, offset_classes=False):
    """(boxes (P, N, 4), scores (P, N)) float32: integer boxes of side 1 to
    27 around 12 centres a problem, bf16-like tied scores. With
    ``offset_classes`` every other box is shifted past the rest, as the
    class-offset trick of batched NMS does."""
    centres = rng.integers(0, span, (P, 12, 2))
    pick = rng.integers(0, 12, (P, N))
    c = np.take_along_axis(centres, pick[..., None], 1) \
        + rng.integers(-3, 4, (P, N, 2))
    half = rng.integers(1, 14, (P, N, 2))
    boxes = np.concatenate([c - half, c + half], -1).clip(0, span)
    if offset_classes:
        boxes[:, 1::2] += span + 1
    scores = np.round(rng.normal(size=(P, N)), 2)
    return boxes.astype(np.float32), scores.astype(np.float32)


def _stair(n):
    """Neighbours overlap at IoU 0.25, boxes two apart not at all."""
    i = np.arange(n, dtype=np.float32)
    return np.stack([i * 6, np.zeros(n), i * 6 + 10, np.full(n, 10.0)],
                    -1).astype(np.float32)


def _case(name):
    """(boxes (..., N, 4), scores (..., N), t) of one case, unsorted."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "rpn_507":
        # the RPN's per-level problems: 2 images x 5 levels of 1000, the
        # last level (P6) with 507 anchors and padding after them
        b, s = _clusters(rng, 10, 1000)
        b, s = b.reshape(2, 5, 1000, 4), s.reshape(2, 5, 1000)
        s[:, 4, 507:] = NEG_INF
        return b, s, 0.7
    if name == "classes_offset_2000":
        b, s = _clusters(rng, 2, 2000, offset_classes=True)
        return b, s, 0.5
    if name == "chain":
        return _stair(300)[None], np.linspace(1, 0.5, 300,
                                              dtype=np.float32)[None], 0.2
    if name == "equal_scores":
        b, _ = _clusters(rng, 2, 500)
        b = np.concatenate([b, np.broadcast_to(_stair(500), (1, 500, 4))])
        return b, np.full((3, 500), 0.25, np.float32), 0.2
    if name == "all_padded":
        b, s = _clusters(rng, 3, 200)
        s[1:] = NEG_INF
        return b, s, 0.5
    n = int(name[1:])                                    # "n<N>"
    b, s = _clusters(rng, 3, n)
    return b, s, 0.5


def _sorted(b, s):
    order = np.argsort(-s, axis=-1, kind="stable")
    return (np.take_along_axis(b, order[..., None], -2),
            np.take_along_axis(s, order, -1))


def _iou_clear_of(b, t):
    """True if no pair's IoU lies within 1e-6 of t without equalling it."""
    b = b.reshape(-1, b.shape[-2], 4).astype(np.float64)
    for p in b:
        lt = np.maximum(p[:, None, :2], p[None, :, :2])
        rb = np.minimum(p[:, None, 2:], p[None, :, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), -1)
        area = np.prod(np.clip(p[:, 2:] - p[:, :2], 0, None), -1)
        union = area[:, None] + area[None, :] - inter
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0)
        d = np.abs(iou - t)
        if ((d > 0) & (d < 1e-6)).any():
            return False
    return True


CASES = ["rpn_507", "classes_offset_2000", "chain", "equal_scores",
         "all_padded", "n1", "n63", "n64", "n65", "n130"]


@pytest.mark.parametrize("name", CASES)
def test_word_sweep_matches_jacobi_and_jax_tpu_kernel(name):
    b, s, t = _case(name)
    sb, ss = _sorted(b, s)
    assert _iou_clear_of(sb, t)
    tb, ts = torch.from_numpy(sb), torch.from_numpy(ss)
    words = suppression_words(tb, ts, t)
    N = ss.shape[-1]
    assert words.shape == ss.shape + (row_words(N),)
    assert row_words(N) % 2 == 0 and row_words(N) * WORD >= N
    assert words.dtype == torch.int64
    got = sweep_words(words, ts)
    jacobi = nms_keep_mask_ref(tb, ts, t)
    flat_b, flat_s = sb.reshape(-1, N, 4), ss.reshape(-1, N)
    ref = np.asarray(j_keep(jnp.asarray(flat_b),
                            jnp.asarray(flat_s > NEG_INF / 2), t,
                            interpret=True)).reshape(ss.shape)
    np.testing.assert_array_equal(got.numpy(), jacobi.numpy())
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "all_padded":
        assert not got[1:].any() and got[0].any()
    if name == "chain":
        np.testing.assert_array_equal(got[0].numpy(), np.arange(N) % 2 == 0)
    if name == "rpn_507":
        assert not got[:, 4, 507:].any()


def test_suppression_word_bits():
    """Bit k of word w of row i: j = 64·w + k > i, both valid, overlap;
    the upper triangle only, and nothing for padding or beyond N."""
    n = 70
    b = np.zeros((n, 4), np.float32)
    b[:, 2:] = 10.0                                      # all identical
    s = np.linspace(1, 0, n, dtype=np.float32)
    s[3] = NEG_INF                                       # one invalid rank
    w = suppression_words(torch.from_numpy(b), torch.from_numpy(s), 0.5)
    bits = ((w[..., None] >> torch.arange(WORD)) & 1).reshape(n, -1)[:, :n]
    valid = torch.from_numpy(s > NEG_INF / 2)
    want = torch.ones((n, n), dtype=torch.bool).triu(1) & valid[:, None] \
        & valid[None, :]
    assert torch.equal(bits.bool(), want)
    # bit 63 is the sign bit of the int64 word
    assert bool(w[0, 0] < 0) and int(w[0, 1]) == (1 << (n - 64)) - 1
