"""COCO-style AP evaluation for the in-loop trainer.

Port of the reference's ``engine/coco_eval.py`` (its periodic detectron2
COCOEvaluator pass, reference config/detectron2_config_3bands.yaml:322):
greedy score-ordered matching per (class, IoU threshold), the IoU grid
0.50:0.95:0.05 and 101-point interpolated AP, for box and instance-mask
IoU, over the whole validation set. The numpy helpers are copies of the
reference's, so both packages give the same AP from the same detections;
:func:`evaluate_dataset` drives the port's forward (``u8`` mask format) in
place of the reference's jitted one, and takes any other ``forward`` the
caller gives it. ``draw_detections`` imports Pillow when it is called and
stays best-effort, as in the reference (the card's installation has no
Pillow: no sample images are written there).
"""

from __future__ import annotations

import os

import numpy as np

_IOU_THRESHOLDS = np.arange(0.5, 0.96, 0.05)


# ---------------------------------------------------------------------------
# geometry helpers


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of XYXY boxes a (D, 4) × b (G, 4) -> (D, G) float32."""
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)), np.float32)
    x0 = np.maximum(a[:, None, 0], b[None, :, 0])
    y0 = np.maximum(a[:, None, 1], b[None, :, 1])
    x1 = np.minimum(a[:, None, 2], b[None, :, 2])
    y1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    ar_a = np.clip(a[:, 2] - a[:, 0], 0, None) \
        * np.clip(a[:, 3] - a[:, 1], 0, None)
    ar_b = np.clip(b[:, 2] - b[:, 0], 0, None) \
        * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = ar_a[:, None] + ar_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


def _bilinear_resize(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """(P, P) float -> (h, w) float, align_corners=False bilinear (the
    paste convention of detectron2's mask head output)."""
    P0, P1 = m.shape
    ys = (np.arange(h, dtype=np.float32) + 0.5) * (P0 / h) - 0.5
    xs = (np.arange(w, dtype=np.float32) + 0.5) * (P1 / w) - 0.5
    y0 = np.clip(np.floor(ys), 0, P0 - 1).astype(np.int32)
    x0 = np.clip(np.floor(xs), 0, P1 - 1).astype(np.int32)
    y1 = np.minimum(y0 + 1, P0 - 1)
    x1 = np.minimum(x0 + 1, P1 - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = m[y0][:, x0] * (1 - wx) + m[y0][:, x1] * wx
    bot = m[y1][:, x0] * (1 - wx) + m[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def paste_mask(prob: np.ndarray, box: np.ndarray, H: int, W: int,
               thresh: float = 0.5) -> np.ndarray:
    """Paste a (P, P) probability map into its box on an (H, W) canvas."""
    out = np.zeros((H, W), bool)
    x0, y0, x1, y1 = box
    ix0 = int(np.floor(x0)); iy0 = int(np.floor(y0))
    ix1 = int(np.ceil(x1)); iy1 = int(np.ceil(y1))
    ix0c, iy0c = max(ix0, 0), max(iy0, 0)
    ix1c, iy1c = min(ix1, W), min(iy1, H)
    if ix1c <= ix0c or iy1c <= iy0c:
        return out
    m = _bilinear_resize(prob, max(iy1 - iy0, 1), max(ix1 - ix0, 1))
    out[iy0c:iy1c, ix0c:ix1c] = \
        m[iy0c - iy0:iy1c - iy0, ix0c - ix0:ix1c - ix0] >= thresh
    return out


def mask_iou_matrix(det_masks: list, gt_masks: np.ndarray) -> np.ndarray:
    """IoU of D pasted detection bitmaps × G ground-truth bitmaps."""
    D, G = len(det_masks), len(gt_masks)
    if not D or not G:
        return np.zeros((D, G), np.float32)
    dm = np.stack([m.reshape(-1) for m in det_masks]).astype(np.float32)
    gm = gt_masks.reshape(G, -1).astype(np.float32)
    inter = dm @ gm.T
    union = dm.sum(1)[:, None] + gm.sum(1)[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


# ---------------------------------------------------------------------------
# COCO accumulation


def _greedy_match(iou: np.ndarray, order: np.ndarray,
                  t: float) -> np.ndarray:
    """Score-ordered greedy matching: each detection takes the unmatched
    GT of highest IoU ≥ t. Returns matched flags aligned to ``order``."""
    D, G = iou.shape
    matched = np.zeros(D, bool)
    taken = np.zeros(G, bool)
    for k, d in enumerate(order):
        best, best_iou = -1, t
        for g in range(G):
            if not taken[g] and iou[d, g] >= best_iou:
                best, best_iou = g, iou[d, g]
        if best >= 0:
            taken[best] = True
            matched[k] = True
    return matched


def _interp_ap(scores: np.ndarray, matched: np.ndarray,
               n_gt: int) -> float:
    """101-point interpolated AP from pooled per-class detections."""
    if n_gt == 0:
        return float("nan")
    if not len(scores):
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = matched[order]
    ctp = np.cumsum(tp)
    cfp = np.cumsum(~tp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1)
    # precision envelope (monotone non-increasing from the right)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    rc = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, rc, side="left")
    p = np.where(idx < len(precision), precision[np.minimum(idx,
                 len(precision) - 1)], 0.0)
    return float(p.mean())


class APAccumulator:
    """Pools per-image matches into AP/AP50/AP75 over classes."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        # per class: list of (scores, matched (T, D)) + gt count
        self.dets = [[] for _ in range(num_classes)]
        self.n_gt = np.zeros(num_classes, np.int64)

    def add_image(self, det_classes, det_scores, iou, gt_classes):
        """iou: (D, G) IoU matrix (box or mask); classes are 0-based."""
        det_classes = np.asarray(det_classes)
        det_scores = np.asarray(det_scores)
        gt_classes = np.asarray(gt_classes)
        for c in range(self.num_classes):
            gsel = np.where(gt_classes == c)[0]
            dsel = np.where(det_classes == c)[0]
            self.n_gt[c] += len(gsel)
            if not len(dsel):
                continue
            sc = det_scores[dsel]
            sub = iou[np.ix_(dsel, gsel)]
            order = np.argsort(-sc, kind="stable")
            m = np.stack([_greedy_match(sub, order, t)
                          for t in _IOU_THRESHOLDS])
            # de-order back to dsel order for pooling with global sort
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            self.dets[c].append((sc, m[:, inv]))

    def summarize(self) -> dict:
        T = len(_IOU_THRESHOLDS)
        ap_tc = np.full((T, self.num_classes), np.nan)
        for c in range(self.num_classes):
            if self.dets[c]:
                scores = np.concatenate([s for s, _ in self.dets[c]])
                matched = np.concatenate([m for _, m in self.dets[c]],
                                         axis=1)
            else:
                scores = np.zeros(0)
                matched = np.zeros((T, 0), bool)
            for ti in range(T):
                ap_tc[ti, c] = _interp_ap(scores, matched[ti],
                                          int(self.n_gt[c]))

        def mean(x):
            return float(np.nanmean(x)) if np.isfinite(x).any() else 0.0

        return {
            "AP": round(mean(ap_tc), 4),
            "AP50": round(mean(ap_tc[0]), 4),
            "AP75": round(mean(ap_tc[5]), 4),
        }


# ---------------------------------------------------------------------------
# the evaluation over a dataset


def evaluate_dataset(state, cfg, ds, image_size: int,
                     batch_size: int = 8, max_images: int | None = None,
                     viz_dir: str | None = None, viz_count: int = 4,
                     viz_tag: str = "", device="cuda",
                     forward=None) -> dict:
    """Full-val-set COCO AP (box + mask) of the inference ``state``
    (``utils.weights.from_jax_params`` or ``fold_train_params``).

    ds: ``pipeline.training.CocoTileDataset``. Runs the forward in padded
    batches, matching on the host. ``forward(images (B, H, W, 3) uint8) ->
    dict of numpy arrays`` (boxes, scores, classes, valid, mask_probs_u8)
    defaults to ``forward_inference`` of ``state`` on ``device``.
    Optionally writes ``viz_count`` tagged sample images (drawn
    boxes/masks/scores) to ``viz_dir``."""
    if forward is None:
        from ..models.mask_rcnn import forward_inference
        from ..utils.device import compute_dtype, resolve_device
        from ..utils.weights import state_to

        dev = resolve_device(device)
        prepared = state_to(state, dev, compute_dtype(cfg))

        def forward(imgs):
            out = forward_inference(prepared, imgs, cfg, mask_format="u8",
                                    device=dev)
            return {k: v.cpu().numpy() for k, v in out.items()}

    n = len(ds) if max_images is None else min(len(ds), max_images)
    box_acc = APAccumulator(cfg.num_classes)
    mask_acc = APAccumulator(cfg.num_classes)
    n_viz = 0

    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        samples = [ds.load(i) for i in idx]
        imgs = np.stack([s[0] for s in samples])
        if len(idx) < batch_size:   # pad the tail batch
            pad = np.zeros((batch_size - len(idx),) + imgs.shape[1:],
                           imgs.dtype)
            imgs = np.concatenate([imgs, pad])
        out = forward(imgs)
        H, W = imgs.shape[1:3]

        for bi, (img, gboxes, gclasses, gvalid, gmasks) in \
                enumerate(samples):
            keep = np.where(out["valid"][bi]
                            & (out["scores"][bi] >= cfg.score_thresh_test)
                            )[0]
            dboxes = out["boxes"][bi][keep]
            dscores = out["scores"][bi][keep]
            dclasses = out["classes"][bi][keep]
            dprobs = out["mask_probs_u8"][bi][keep].astype(np.float32) / 255.0
            gsel = np.where(gvalid)[0]
            gb, gc, gm = gboxes[gsel], gclasses[gsel], gmasks[gsel]

            biou = box_iou_matrix(dboxes, gb)
            pasted = [paste_mask(dprobs[d], dboxes[d], H, W)
                      for d in range(len(keep))]
            miou = mask_iou_matrix(pasted, gm.astype(bool))
            box_acc.add_image(dclasses, dscores, biou, gc)
            mask_acc.add_image(dclasses, dscores, miou, gc)

            if viz_dir and n_viz < viz_count:
                try:
                    draw_detections(
                        img, dboxes, dscores, dclasses, pasted,
                        os.path.join(viz_dir,
                                     f"sample_{viz_tag}_{n_viz:02d}.png"))
                    n_viz += 1
                except Exception:   # viz is best-effort, never fails eval
                    pass

    b = box_acc.summarize()
    m = mask_acc.summarize()
    return {f"bbox/{k}": v for k, v in b.items()} \
        | {f"segm/{k}": v for k, v in m.items()}


_CLASS_COLORS = [(255, 64, 32), (32, 128, 255), (64, 224, 64),
                 (255, 192, 0), (192, 64, 255)]


def draw_detections(img: np.ndarray, boxes, scores, classes, masks,
                    out_path: str) -> None:
    """Write a tagged sample image: mask overlay + box + 'class score'
    labels (the reference trainer's sample visualizations)."""
    from PIL import Image, ImageDraw

    canvas = img.copy()
    for d in range(len(boxes)):
        color = np.asarray(_CLASS_COLORS[int(classes[d])
                                         % len(_CLASS_COLORS)], np.float32)
        if d < len(masks) and masks[d] is not None and masks[d].any():
            sel = masks[d]
            canvas = canvas.astype(np.float32)
            canvas[sel] = canvas[sel] * 0.55 + color * 0.45
            canvas = canvas.astype(np.uint8)
    im = Image.fromarray(canvas)
    dr = ImageDraw.Draw(im)
    for d in range(len(boxes)):
        color = tuple(_CLASS_COLORS[int(classes[d]) % len(_CLASS_COLORS)])
        x0, y0, x1, y1 = [float(v) for v in boxes[d]]
        dr.rectangle([x0, y0, x1, y1], outline=color, width=2)
        dr.text((x0 + 2, max(y0 - 10, 0)),
                f"{int(classes[d])} {float(scores[d]):.2f}", fill=color)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    im.save(out_path)
