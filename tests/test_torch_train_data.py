"""The training loader of the PyTorch port against the JAX package's, on
the CPU: the polygon fill (``csrc/rasterize.cpp``, a copy of the
reference's C++ fill), ``CocoTileDataset.load``, the Pillow-free resizes
(``pipeline/resize.py``) against Pillow itself, ``resize_sample``,
``augment_sample`` (flip, multiscale resize, scale jitter with both its
crop and its pad), ``make_batch`` and ``Prefetcher``, with the same
``np.random.default_rng`` seeds. Everything exact, byte for byte.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from roadsurf_tpu.geom import _native as jn
from roadsurf_tpu.io.geotiff import write_geotiff
from roadsurf_tpu.pipeline import training as jtr
from roadsurf_tpu_torch.geom import _native as tn
from roadsurf_tpu_torch.pipeline import training as ttr
from roadsurf_tpu_torch.pipeline.resize import resize_bilinear, \
    resize_nearest

torch.set_num_threads(1)

SIZES = (640, 672, 704, 736, 768, 800)


def _polygons(rng, S: int) -> list:
    """COCO segmentations: a thin rotated road, a triangle, a square with a
    square hole (two rings), a road running off the tile, one with a
    repeated vertex and an explicit closing vertex."""
    c = rng.uniform(S * 0.3, S * 0.7, 2)
    a = rng.uniform(0, np.pi)
    d = np.array([np.cos(a), np.sin(a)]) * S * 0.4
    e = np.array([-np.sin(a), np.cos(a)]) * 3.3
    road = np.stack([c - d - e, c + d - e, c + d + e, c - d + e])
    tri = np.array([[5.5, 7.25], [S * 0.6, 12.0], [20.0, S * 0.5]])
    outer = np.array([[10, 40], [40, 40], [40, 60], [10, 60]], float)
    hole = np.array([[20, 45], [30, 45], [30, 55], [20, 55]], float)
    off = np.array([[-10, S - 8], [S + 20, S - 14], [S + 20, S - 4],
                    [-10, S + 3]], float)
    rep = np.array([[3, 3], [3, 3], [15, 3], [15, 18], [3, 3]], float)
    return [[road], [tri], [outer, hole], [off], [rep]]


def _mini_coco(tmp_path, n_images: int = 3, S: int = 64, G: int = 6):
    img_dir = tmp_path / "trn-images"
    img_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(n_images):
        fn = f"18_{1000 + i}_2000.tif"
        write_geotiff(str(img_dir / fn),
                      rng.integers(0, 255, (S, S, 3), dtype=np.uint8),
                      (0, 0, S, S))
        images.append({"id": i + 1, "file_name": fn, "width": S,
                       "height": S})
        for k, rings in enumerate(_polygons(rng, S)[:G - i]):
            xy = np.concatenate(rings)
            x0, y0 = np.clip(xy.min(0), 0, S)
            x1, y1 = np.clip(xy.max(0), 0, S)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1 + k % 2,
                         "segmentation": [r.reshape(-1).tolist()
                                          for r in rings],
                         "bbox": [x0, y0, x1 - x0, y1 - y0],
                         "area": 1.0, "iscrowd": 0})
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": 2, "name": "natural"},
                           {"id": 1, "name": "artificial"}]}
    p = tmp_path / "COCO_trn.json"
    p.write_text(json.dumps(coco))
    return str(p), str(img_dir)


def _equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_rasterize_equals_the_reference():
    rng = np.random.default_rng(1)
    for rings in _polygons(rng, 64):
        for x0, dx, y0, dy in ((0.0, 1.0, 0.0, 1.0), (2.5, 0.75, 70.0, -1.3)):
            got = tn.rasterize(tn.pack([rings]), x0, dx, y0, dy, 48, 64,
                               value=3)
            ref = jn.rasterize(jn.pack([rings]), x0, dx, y0, dy, 48, 64,
                               value=3)
            np.testing.assert_array_equal(got, ref)
    assert got.any()
    assert not tn.rasterize(tn.pack([]), 0.0, 1.0, 0.0, 1.0, 4, 4).any()


def test_dataset_load_equals_the_reference(tmp_path):
    coco, img_dir = _mini_coco(tmp_path)
    ref = jtr.CocoTileDataset(coco, img_dir, max_instances=5)
    got = ttr.CocoTileDataset(coco, img_dir, max_instances=5)
    assert len(got) == len(ref) == 3
    assert got.cat_to_class == ref.cat_to_class == {1: 0, 2: 1}
    for i in range(3):
        _equal(got.load(i), ref.load(i))
    masks = got.load(0)[4]
    assert masks.shape == (5, 64, 64) and masks[:5].any(axis=(1, 2)).all()


@pytest.mark.parametrize("src,dst", [(256, 800), (256, 640), (256, 205),
                                     (256, 320), (64, 51), (64, 80),
                                     (37, 101), (101, 37)])
def test_resizes_equal_pillow(src, dst):
    """BILINEAR on RGB and single-band images (up, down with the widened
    filter, and off-integer ratios) and NEAREST on bitmaps."""
    rng = np.random.default_rng(src * dst)
    img = rng.integers(0, 256, (src, src, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((dst, dst),
                                                 Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, dst, dst), ref)
    band = img[:, :, 0].copy()
    np.testing.assert_array_equal(
        resize_bilinear(band, dst, dst),
        np.asarray(Image.fromarray(band).resize((dst, dst), Image.BILINEAR)))
    m = (rng.random((src, src)) < 0.3).astype(np.uint8) * 255
    np.testing.assert_array_equal(
        resize_nearest(m, dst, dst),
        np.asarray(Image.fromarray(m).resize((dst, dst), Image.NEAREST)))


def test_resize_sample_equals_the_reference(tmp_path):
    coco, img_dir = _mini_coco(tmp_path, n_images=1, S=256)
    sample = ttr.CocoTileDataset(coco, img_dir, 6).load(0)
    img, boxes, _, _, masks = sample
    for target in SIZES + (256,):
        _equal(ttr.resize_sample(img, boxes, masks, target),
               jtr.resize_sample(img, boxes, masks, target))
    empty = np.zeros((0, 256, 256), np.uint8)
    _equal(ttr.resize_sample(img, boxes[:0], empty, 640),
           jtr.resize_sample(img, boxes[:0], empty, 640))


def test_augment_sample_equals_the_reference(tmp_path):
    """Jitter draws with s across 0.8..1.25: crops (s > 1), pads (s < 1)
    and flips, each draw from its own rng seed in both packages; and the
    multiscale branch at every MIN_SIZE_TRAIN choice."""
    coco, img_dir = _mini_coco(tmp_path, n_images=1, S=64)
    sample = ttr.CocoTileDataset(coco, img_dir, 6).load(0)
    seen = set()
    for seed in range(14):
        rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ttr.augment_sample(rng_t, *sample)
        _equal(got, jtr.augment_sample(rng_j, *sample))
        probe = np.random.default_rng(seed)
        flip, s = probe.random() < 0.5, probe.uniform(0.8, 1.25)
        seen.add((flip, s > 1.0))
        assert rng_t.random() == rng_j.random()     # the same draws taken
    assert seen == {(False, False), (False, True), (True, False),
                    (True, True)}
    for seed, target in enumerate(SIZES):
        _equal(ttr.augment_sample(np.random.default_rng(seed), *sample,
                                  target_size=target),
               jtr.augment_sample(np.random.default_rng(seed), *sample,
                                  target_size=target))


def test_make_batch_and_prefetcher_equal_the_reference(tmp_path):
    coco, img_dir = _mini_coco(tmp_path, n_images=3, S=64)
    tds = ttr.CocoTileDataset(coco, img_dir, 6)
    jds = jtr.CocoTileDataset(coco, img_dir, 6)
    idx = np.asarray([2, 0, 1, 2])
    for augment, target in ((True, None), (True, 96), (False, 80)):
        got = ttr.make_batch(tds, np.random.default_rng(4), idx, augment,
                             target_size=target)
        ref = jtr.make_batch(jds, np.random.default_rng(4), idx, augment,
                             target_size=target)
        assert sorted(got) == sorted(ref)
        _equal([got[k] for k in sorted(got)], [ref[k] for k in sorted(ref)])
    tp = ttr.Prefetcher(tds, 2, seed=7, sizes=(64, 96))
    jp = jtr.Prefetcher(jds, 2, seed=7, sizes=(64, 96))
    try:
        for _ in range(3):
            got, ref = tp.next(), jp.next()
            _equal([got[k] for k in sorted(got)],
                   [ref[k] for k in sorted(ref)])
    finally:
        tp.close()
        jp.close()
    assert not tp.thread.is_alive()
