"""The COCO evaluation of the PyTorch port (``engine/coco_eval.py``)
against the JAX package's, on the CPU: every numpy helper on the cases of
``tests/test_coco_eval.py`` and on random inputs, and ``evaluate_dataset``
of both packages on one stub forward that returns the same detections
(the reference's ``_jitted_infer`` patched, the port's ``forward``
given), with the sample images both write. Everything exact.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from roadsurf_tpu.engine import coco_eval as jce
from roadsurf_tpu.models.config import fast_profile as j_fast
from roadsurf_tpu_torch.engine import coco_eval as tce
from roadsurf_tpu_torch.models import fast_profile

torch.set_num_threads(1)


def _sq(x0, y0, x1, y1):
    return np.asarray([x0, y0, x1, y1], np.float32)


# the cases of tests/test_coco_eval.py: (det boxes, det classes, scores, gt
# boxes, gt classes, num classes)
CASES = {
    "perfect": (np.stack([_sq(0, 0, 10, 10), _sq(20, 20, 40, 40)]), [0, 1],
                [0.9, 0.8], np.stack([_sq(0, 0, 10, 10), _sq(20, 20, 40, 40)]),
                [0, 1], 2),
    "false_positive_first": (np.stack([_sq(50, 50, 60, 60),
                                       _sq(0, 0, 10, 10)]), [0, 0],
                             [0.9, 0.8], np.stack([_sq(0, 0, 10, 10)]), [0],
                             1),
    "iou_0.6": (np.stack([_sq(0, 0, 10, 6.0)]), [0], [0.9],
                np.stack([_sq(0, 0, 10, 10)]), [0], 1),
    "missed_gt": (np.stack([_sq(0, 0, 10, 10)]), [0], [0.9],
                  np.stack([_sq(0, 0, 10, 10), _sq(30, 30, 50, 50)]), [0, 0],
                  1),
    "greedy_best_iou": (np.stack([_sq(2, 0, 12, 10)]), [0], [0.9],
                        np.stack([_sq(0, 0, 10, 10), _sq(2, 0, 12, 10)]),
                        [0, 0], 1),
    "wrong_class": (np.stack([_sq(0, 0, 10, 10)]), [1], [0.9],
                    np.stack([_sq(0, 0, 10, 10)]), [0], 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_box_ap_cases_are_exact(case):
    dets, dcls, scores, gts, gcls, K = CASES[case]
    iou_j = jce.box_iou_matrix(dets, gts)
    iou_t = tce.box_iou_matrix(dets, gts)
    np.testing.assert_array_equal(iou_t, iou_j)
    acc_j, acc_t = jce.APAccumulator(K), tce.APAccumulator(K)
    acc_j.add_image(dcls, scores, iou_j, gcls)
    acc_t.add_image(dcls, scores, iou_t, gcls)
    assert acc_t.summarize() == acc_j.summarize()


def test_mask_helpers_are_exact():
    prob = np.ones((28, 28), np.float32)
    for box, H in ((_sq(4, 6, 12, 16), 32), (_sq(-5, -5, 5, 5), 16),
                   (_sq(3.3, 1.7, 20.2, 9.9), 24), (_sq(30, 30, 40, 40), 16)):
        np.testing.assert_array_equal(tce.paste_mask(prob, box, H, H),
                                      jce.paste_mask(prob, box, H, H))
    rng = np.random.default_rng(0)
    m = rng.random((28, 28)).astype(np.float32)
    for h, w in ((5, 9), (28, 28), (61, 40), (1, 1)):
        np.testing.assert_array_equal(tce._bilinear_resize(m, h, w),
                                      jce._bilinear_resize(m, h, w))
    a = np.zeros((16, 16), bool)
    a[:8] = True
    b = np.zeros((16, 16), bool)
    b[4:12] = True
    np.testing.assert_array_equal(
        tce.mask_iou_matrix([a], np.stack([b, a])),
        jce.mask_iou_matrix([a], np.stack([b, a])))
    assert tce.mask_iou_matrix([], np.stack([a])).shape == (0, 1)


def test_matching_and_ap_on_random_inputs_are_exact():
    rng = np.random.default_rng(1)
    acc_j, acc_t = jce.APAccumulator(2), tce.APAccumulator(2)
    for _ in range(6):
        D, G = rng.integers(0, 12), rng.integers(0, 6)
        dets = np.sort(rng.uniform(0, 64, (D, 2, 2)), 1).transpose(
            0, 2, 1).reshape(D, 4)[:, [0, 2, 1, 3]].astype(np.float32)
        gts = np.sort(rng.uniform(0, 64, (G, 2, 2)), 1).transpose(
            0, 2, 1).reshape(G, 4)[:, [0, 2, 1, 3]].astype(np.float32)
        scores = np.round(rng.random(D), 1)             # ties included
        dcls, gcls = rng.integers(0, 2, D), rng.integers(0, 2, G)
        iou = jce.box_iou_matrix(dets, gts)
        order = np.argsort(-scores, kind="stable")
        for t in (0.5, 0.75):
            np.testing.assert_array_equal(tce._greedy_match(iou, order, t),
                                          jce._greedy_match(iou, order, t))
        acc_j.add_image(dcls, scores, iou, gcls)
        acc_t.add_image(dcls, scores, iou, gcls)
        m = rng.random(D) < 0.5
        assert tce._interp_ap(scores, m, G) == pytest.approx(
            jce._interp_ap(scores, m, G), nan_ok=True, abs=0)
    assert acc_t.summarize() == acc_j.summarize()


class StubDataset:
    """Five 64 px tiles with one to three GT instances each (boxes of both
    classes, bitmaps filling them)."""

    def __len__(self):
        return 5

    def load(self, i):
        rng = np.random.default_rng(10 + i)
        img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
        G = 4
        boxes = np.zeros((G, 4), np.float32)
        classes = rng.integers(0, 2, G).astype(np.int32)
        valid = np.arange(G) < 1 + i % 3
        masks = np.zeros((G, 64, 64), np.uint8)
        for g in np.flatnonzero(valid):
            x0, y0 = rng.integers(0, 40, 2)
            w, h = rng.integers(6, 24, 2)
            boxes[g] = (x0, y0, x0 + w, y0 + h)
            masks[g, y0:y0 + h, x0:x0 + w] = 1
        return img, boxes, classes, valid, masks


def _stub_forward(imgs: np.ndarray) -> dict:
    """Detections derived from the tiles' pixels: the same for both
    packages, some near the GT, some not, a few below the score
    threshold."""
    B, D = imgs.shape[0], 6
    out = {"boxes": np.zeros((B, D, 4), np.float32),
           "scores": np.zeros((B, D), np.float32),
           "classes": np.zeros((B, D), np.int32),
           "valid": np.zeros((B, D), bool),
           "mask_probs_u8": np.zeros((B, D, 28, 28), np.uint8)}
    ds = StubDataset()
    for b in range(B):
        rng = np.random.default_rng(int(imgs[b].sum()) % 1000)
        n = 0 if not imgs[b].any() else 1 + b % 3
        gt = [ds.load(i) for i in range(len(ds))
              if np.array_equal(ds.load(i)[0], imgs[b])]
        for d in range(min(D, n + 2)):
            if gt and d < n and gt[0][3][d]:
                box = gt[0][1][d] + rng.normal(0, 1.5, 4)
            else:
                box = np.sort(rng.uniform(0, 64, 4).reshape(2, 2), 0) \
                    .T.reshape(4)[[0, 2, 1, 3]]
            out["boxes"][b, d] = box
            out["scores"][b, d] = rng.choice([0.02, 0.3, 0.6, 0.9])
            out["classes"][b, d] = rng.integers(0, 2)
            out["valid"][b, d] = True
            out["mask_probs_u8"][b, d] = rng.integers(0, 256, (28, 28))
    return out


def test_evaluate_dataset_equals_the_reference(monkeypatch, tmp_path):
    jcfg = replace(j_fast(post_nms_topk=8, detections_per_image=6),
                   min_size_test=64, max_size_test=64)
    tcfg = replace(fast_profile(post_nms_topk=8, detections_per_image=6),
                   min_size_test=64, max_size_test=64)
    monkeypatch.setattr(jce, "_jitted_infer",
                        lambda cfg: lambda params, imgs: _stub_forward(imgs))
    ref = jce.evaluate_dataset(None, jcfg, StubDataset(), 64, batch_size=2,
                               viz_dir=str(tmp_path / "ref"), viz_count=3,
                               viz_tag="000002")
    got = tce.evaluate_dataset(None, tcfg, StubDataset(), 64, batch_size=2,
                               viz_dir=str(tmp_path / "port"), viz_count=3,
                               viz_tag="000002", device="cpu",
                               forward=_stub_forward)
    assert got == ref
    assert sorted(got) == ["bbox/AP", "bbox/AP50", "bbox/AP75", "segm/AP",
                           "segm/AP50", "segm/AP75"]
    assert 0 < got["bbox/AP50"] <= 1
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for n in names:
        assert (tmp_path / "ref" / n).read_bytes() \
            == (tmp_path / "port" / n).read_bytes()
