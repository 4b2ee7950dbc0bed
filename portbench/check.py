"""The comparison that decides ``correct``: the program's outputs for a
sample of the window's tiles against the plain reference's on the same
tiles and weights.

With random weights a detection that survives NMS, the score threshold or
the top ``detections_per_image`` can change on one rounding: where two
candidates tie, the program (bf16) and the reference (float32) may keep
either. So detections are not compared slot by slot. They are matched one
to one, the reference's in order of score, each to the program's
unmatched detection of its class that overlaps it most, at IoU >=
``MATCH_IOU`` (two candidates that NMS weighs against each other overlap
by at least its threshold, so a flipped tie still matches), and a
detection left without a partner is excused where its score lies within
``CUT_DELTA`` of what the other side still admits (its lowest kept score
where its slots are full, else the threshold). The numbers, each over all
sampled tiles:

* ``unmatched``: detections of either side without a partner and not
  excused, as a share of both sides' detections: missing, extra, of the
  wrong class or far off;
* ``box_err``: the median over matched pairs of the largest coordinate
  difference, over the reference box's longer side;
* ``score_err``: the median over matched pairs of the difference of the
  scores' logits, |ln(s/(1-s)) - ln(r/(1-r))|;
* ``mask_err``: the share of the program's mask bits that disagree with
  the reference's mask head run on the program's own boxes and classes
  (so that a mask is judged on the box it came with), among cells whose
  reference logit is at least ``MASK_MARGIN`` of that mask's median
  |logit| away from 0.

Each has a limit in the configuration's file (``limits``), set between
the program's readings and the control's (PERF.md); a run is correct iff
every number is at most its limit and every tile handed over came back.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import pack_bits

MATCH_IOU = 0.5
CUT_DELTA = 0.005
MASK_MARGIN = 0.05


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1],
                                                           0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1],
                                                           0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def match(pb, ps, pc, rb, rs, rc) -> list:
    """Pairs (i_program, j_reference): the reference's detections by
    descending score, each to the unmatched program detection of its class
    with the largest IoU, if that is >= MATCH_IOU."""
    if len(pb) == 0 or len(rb) == 0:
        return []
    iou = _iou(np.asarray(pb, np.float64), np.asarray(rb, np.float64))
    iou[np.asarray(pc)[:, None] != np.asarray(rc)[None, :]] = -1.0
    free = np.ones(len(pb), bool)
    pairs = []
    for j in np.argsort(-np.asarray(rs), kind="stable"):
        col = np.where(free, iou[:, j], -1.0)
        i = int(np.argmax(col))
        if col[i] >= MATCH_IOU:
            free[i] = False
            pairs.append((i, int(j)))
    return pairs


def _pct(values, q: float) -> float:
    return float(np.percentile(values, q)) if len(values) else 0.0


def _cut(scores, D: int, thr: float) -> float:
    """The lowest score a side would still admit: its lowest kept score
    where its D slots are full, else the threshold."""
    return float(np.min(scores)) if len(scores) >= D else thr


def _logit(s: float) -> float:
    s = min(max(s, 1e-12), 1.0 - 1e-7)
    return float(np.log(s / (1.0 - s)))


def readings(program: list, reference: list, thr: float, D: int) -> dict:
    """``program``: per sampled tile a dict of the engine's arrays (boxes,
    scores, classes, valid, mask_bits); ``reference``: :func:`reference.run`
    of the same tiles with the program's valid boxes given; ``thr`` and
    ``D``: the score threshold and the detections a tile. -> the numbers
    and the counts behind them."""
    total = unmatched = 0
    dscore, dbox = [], []
    flips = cells = 0
    n_prog = n_ref = 0
    for p, r in zip(program, reference):
        v = np.asarray(p["valid"], bool)
        pb, ps, pc = p["boxes"][v], p["scores"][v], p["classes"][v]
        rb = r["boxes"].double().cpu().numpy()
        rs = r["scores"].double().cpu().numpy()
        rc = r["classes"].cpu().numpy()
        pairs = match(pb, ps, pc, rb, rs, rc)
        n_prog += len(pb)
        n_ref += len(rb)
        total += len(pb) + len(rb)
        mp = {i for i, _ in pairs}
        mr = {j for _, j in pairs}
        cut_p, cut_r = _cut(ps, D, thr), _cut(rs, D, thr)
        unmatched += sum(float(ps[i]) >= cut_r + CUT_DELTA
                         for i in range(len(ps)) if i not in mp)
        unmatched += sum(float(rs[j]) >= cut_p + CUT_DELTA
                         for j in range(len(rs)) if j not in mr)
        for i, j in pairs:
            side = max(rb[j][2] - rb[j][0], rb[j][3] - rb[j][1], 1.0)
            dbox.append(float(np.abs(pb[i].astype(np.float64)
                                     - rb[j]).max()) / side)
            dscore.append(abs(_logit(float(ps[i])) - _logit(rs[j])))
        lg = r["given_mask_logits"]
        ref_bits = pack_bits(lg).cpu().numpy()
        got = np.asarray(p["mask_bits"])[v]
        if got.size:
            x = np.unpackbits(np.bitwise_xor(got, ref_bits), axis=-1,
                              bitorder="little").astype(bool)
            a = lg.abs().reshape(lg.shape[0], -1).double().cpu().numpy()
            sure = a >= MASK_MARGIN * np.median(a, axis=1, keepdims=True)
            flips += int((x & sure).sum())
            cells += int(sure.sum())
    return {"unmatched": unmatched / total if total else 0.0,
            "box_err": _pct(dbox, 50),
            "score_err": _pct(dscore, 50),
            "mask_err": flips / cells if cells else 0.0,
            "detections_program": n_prog, "detections_reference": n_ref,
            "pairs": len(dscore), "tiles": len(program)}


def verdict(values: dict, limits: dict, returned: int,
            attempted: int) -> tuple[bool, dict]:
    """-> (correct, {number: {value, limit}}): every number of
    ``limits`` at most its limit, and every tile handed over returned."""
    shown = {n: {"value": values[n], "limit": limits[n]} for n in limits}
    shown["tiles_returned"] = {"value": returned, "limit": attempted}
    ok = all(values[n] <= limits[n] for n in limits) and returned == attempted \
        and all(np.isfinite(values[n]) for n in limits)
    return bool(ok), shown


def given_boxes(program: list, device) -> list:
    """Per sampled tile the program's valid (boxes, classes), on
    ``device``: what the reference's mask head pools."""
    out = []
    for p in program:
        v = np.asarray(p["valid"], bool)
        out.append((torch.as_tensor(np.asarray(p["boxes"][v], np.float32),
                                    device=device),
                    torch.as_tensor(np.asarray(p["classes"][v], np.int64),
                                    device=device)))
    return out
