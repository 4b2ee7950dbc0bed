#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order, one JSON line each; any failure raises and the script
exits non-zero:

1. ``build``: nvcc builds every kernel of the port from ``csrc/`` (one
   process per source, all started together).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at its main path's shapes and on edge batches; its time, the plain
   version's time and the least time the card could take.
   K1 (``roi_align``): the fast profile's poolers (B=64, C=256, P2..P4 at
   256 px tiles; box R=32 P=7, mask R=8 P=14, s=2), and on the edge batch
   (a full-width road across 64 P2 cells, boxes on every level boundary)
   also cases that cross the work split it shares with K2 (``SPLIT``: R
   of 37 and 13, P = 28). K2
   (``roi_align_blocked``): the parity profile's poolers (B=16, C=256,
   P2..P5 at 800 px; box R=1000 P=7, mask R=100 P=14, adaptive) and the
   box pooler at s=2. Both poolers also in their int8 mode, at the same
   shapes, on int8 levels quantized from those (one scale a level); beside
   the byte bound each K2 case reports ``box_bytes``, the cells each box
   touches summed over the boxes, and edge batches also cross K2's work
   split (R of 37 and 13, a row wider than a staged chunk, a short last
   band of output rows, P = 28's four columns a warp). K3 (``nms``): the
   parity profile's NMS problems (RPN: 16·5 problems of 1000 boxes at
   t=0.7; classes: 16 problems of 2000 boxes at t=0.5), N of 1, 63, 64,
   65, 130 and 3000, suppression
   chains, equal scores and all-padded problems, held equal bit for bit,
   its pair phase's words equal to ``suppression_words`` and the plain
   mirror of its sweep on them equal too; the two phases' device times
   (torch.profiler) beside the call's. K4 (``int8_gemm``): the fast
   profile's backbone 1x1 convs at B=64 and box FC1 as GEMMs, raw and
   with the bf16 and int8 epilogues, each held equal bit for bit, beside
   ``torch._int_mm``, with the device time of the call's kernels; and,
   untimed, the ragged shapes of ``GEMM_EDGES`` (M, K, N off the tiles and
   off TMA's 16-byte rule, a misaligned ``a``), bit for bit in every
   mode. K5 (``roi_align_backward``): the poolers' gradient at the
   training shapes (``K5_CASES``: the YAML's box R=1016 P=7 and mask M=128
   P=14 at 800 px, adaptive; the fast profile's at 256 px, s=2), its f32
   gradients against the plain gradient at B=2 (and its bf16 output
   within one bf16 rounding), on random and on edge batches (boxes on
   every level, zero GT boxes, boxes on and across the borders), each
   launched twice and held bitwise equal (one write a tile, no atomics);
   timed at B=8 beside its plain time and its byte bound, with the
   histogram of kept boxes per tile and level (``_k5_tiles``).
3. ``main_path``: the fast profile (R50-FPN at full width, bf16, random
   weights from a seed) through ``TileInferenceEngine.run`` over batches of
   64 random 256 px tiles, the last one short; K1 must have been launched
   twice per batch, and the outputs must be finite, of the right shapes,
   with valid detections, and equal to a direct ``forward_inference`` of
   the same batch (first and short last batch).
4. ``profile``: device time by kernel over two more batches of that path
   (torch.profiler) and the device's busy share of the wall clock.
5. ``main_path_parity``: the parity profile, the configuration
   ``make_detections`` builds from config/detectron2_config_3bands.yaml
   (800 px, adaptive sampling, 1000 proposals, 100 detections, exact
   NMS), through ``TileInferenceEngine(batch_size=16, mask_format="bits")``
   over batches of random 256 px tiles, the last one short, with the same
   checks; K2 and K3 must have been launched twice per batch each.
6. ``profile`` of the parity path.
7. ``main_path_int8``: the reference's deployment configuration, the one
   ``bench.py`` runs by default — the fast profile with ``int8_scope
   "full"`` and ``int8_pyramid`` — calibrated by the port's
   ``prepare_quantized`` on 8 random 256 px tiles, through the engine at
   B=64 with the same checks; K1 must have run twice a batch in its int8
   mode and never in its bf16 mode. Then its ``profile``.
8. ``main_path_parity_int8``: the parity profile with the same int8
   settings (B=16, bits); K2 twice a batch in its int8 mode, K3 twice.
   Then its ``profile``.
9. ``main_path_dense``: ``dense_profile()`` (256 px, fixed 2x2 sampling,
   exact NMS, 256 proposals, 16 detections) in bf16 through the engine at
   B=64, batches of 64 and 40: the one configuration that pairs K1 with
   K3, each twice a batch, with the same checks. Then its ``profile``.
10. ``host_stage``: the port's ``make_detections`` end to end. 20 random
   zoom-18 GeoTIFF tiles, their COCO list and metadata and the weights
   (``logs/model_0005999.npz``) in a temporary working directory; the
   ``make_detections.py`` block of config/config_obj_detec.yaml through
   ``pipeline.detections.run`` (the parity profile in bf16, bits, B=16:
   batches of 16 and 4). Checks: the checkpoint merged with nothing
   skipped; K2 and K3 twice a batch; one gpkg layer ``tst_detections`` in
   EPSG:4326 with ``score REAL`` and ``det_class INTEGER``; at least one
   record, every class 0 or 1, every score in [0.05, 1], every envelope
   inside the tiles (one pixel of slack); and the first 4 tiles' records
   (WKB, score, class) equal to the per-image host stage run on a direct
   ``forward_inference`` of the first batch. Its line holds the stage
   breakdown (decode, vectorize thread-seconds, h2d, d2h), end-to-end
   tiles/s, the record counts, the gpkg's size, a cProfile split of the
   4 tiles' host stage, the first batch's host stage timed in one thread,
   and the same run repeated warm (uncounted).
11. ``train_path``: the port's ``train_model``, ``pipeline.training.train``
   with the YAML's model at full width (multiscale 640..800, B=8, bf16)
   for 6 steps over a synthetic tileset (24 train and 8 val zoom-18
   GeoTIFF tiles of road polygons, in a temporary directory under
   ``_build/``), from random weights, with its eval and its checkpoint at
   step 6. Checks: finite losses; per step K2 2, K5 2 and K3 1 launches;
   ``model_0000005.npz`` in the reference's schema, loaded into
   ``TileInferenceEngine``, which answers a batch; the eval's six AP keys
   finite. Its line holds s/step, images/s, the peak of allocated memory,
   the eval's seconds, a warm step at every size and one step's device
   split (torch.profiler).

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor cores (data sheet)
# |kernel - plain| <= 2^-8·|plain| + 1e-4, for K1 and K2: one bf16 rounding
# of the output (half an ulp, at most 2^-9 relative) over f32 sums taken in
# another order (the kernels wy·Σ wx·f per row, the plain versions
# (Σ wy·f)·wx): a few ulps of Σ|w·f| ≤ max |f| ~ 5, ~1e-5. The
# weights themselves, and so every sample's border decision, are computed
# with the same operations in both. A misplaced sample costs ~1e-1.
REL_TOL, ABS_TOL = 2.0 ** -8, 1e-4
C = 256
# fast profile: batch, tile side, poolers (name, R, P)
B, TILE = 64, 256
POOLERS = (("box", 32, 7), ("mask", 8, 14))
# K1's work split crossed (edge boxes): R that fills no round count of
# blocks, a short last band of output rows (P = 14), and P = 28's four
# output columns a warp in bands of two rows
SPLIT = (("box_r37", 37, 7), ("mask_r13", 13, 14), ("p28_r13", 13, 28))
# parity profile: batch, resized side, P2..P5 sides, poolers (name, R, P, s)
PB, PSIDE = 16, 800
PLEVELS = (200, 100, 50, 25)
PPOOLERS = (("box", 1000, 7, 0), ("mask", 100, 14, 0),
            ("box_s2", 1000, 7, 2))
# K2's work split crossed: R that fills no round count of blocks, and the
# edge boxes (the full-width road at P2 spans more cells than one staged
# chunk holds; P = 14 leaves a short last band of output rows; P = 28 runs
# four output columns a warp in bands of two rows)
PSPLIT = (("box_r37", 37, 7, 0), ("mask_r13", 13, 14, 0),
          ("p28_r13", 13, 28, 0))
ROOT = os.path.dirname(os.path.abspath(__file__))
YAML = "config/detectron2_config_3bands.yaml"
PAIR_FLOPS = 12                 # f32 operations of one NMS pair test
# K4: the fast profile's backbone 1x1 convs at B=64 as (M = 64·H·W, K, N)
# GEMMs (scripts/bench_int8_gemm.py:46-52 at batch 64) and box FC1
GEMMS = (("C2 1x1 256>64", B * 64 * 64, 256, 64),
         ("C3 1x1 512>128", B * 32 * 32, 512, 128),
         ("C3 1x1 128>512", B * 32 * 32, 128, 512),
         ("C4 1x1 1024>256", B * 16 * 16, 1024, 256),
         ("C4 1x1 256>1024", B * 16 * 16, 256, 1024),
         ("C5 1x1 2048>512", B * 8 * 8, 2048, 512),
         ("boxFC1", B * 32, 7 * 7 * C, 1024))
# K4 off the main shapes (untimed): M not a multiple of a tile; K not a
# multiple of the 128-deep slice, 8-aligned (72) and 16-aligned (80); K and
# N off TMA's 16-byte rule (a read through a padded copy); N = 8; and an
# ``a`` view whose base lies 4 bytes off 16 (name, M, K, N, byte offset)
GEMM_EDGES = (("M1000", 1000, 256, 128, 0), ("K72", 512, 72, 64, 0),
              ("K80", 512, 80, 192, 0), ("K100 N24", 300, 100, 24, 0),
              ("N8", 256, 128, 8, 0), ("a+4", 1000, 256, 128, 4))
INT8 = {"int8_scope": "full", "int8_pyramid": True}


def _require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def _emit(obj: dict):
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float, peak: float = F32_FLOPS_PER_S
           ) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def _counters() -> dict:
    """{count name: (wrapper, attribute)}: each wrapper counts its launches,
    the poolers per mode."""
    from roadsurf_tpu_torch.ops.int8_gemm import int8_gemm
    from roadsurf_tpu_torch.ops.nms_kernel import nms_keep_mask
    from roadsurf_tpu_torch.ops.roi_align_backward_kernel import \
        roi_align_backward
    from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
        roi_align_fused_blocked
    from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused

    return {"roi_align": (roi_align_fused, "launches"),
            "roi_align_int8": (roi_align_fused, "launches_int8"),
            "roi_align_blocked": (roi_align_fused_blocked, "launches"),
            "roi_align_blocked_int8": (roi_align_fused_blocked,
                                       "launches_int8"),
            "nms": (nms_keep_mask, "launches"),
            "int8_gemm": (int8_gemm, "launches"),
            "roi_align_backward": (roi_align_backward, "launches")}


def _reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counts() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


# ---------------------------------------------------------------------------
# build

def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from roadsurf_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cuda_build.SOURCES)) as ex:
        futs = {name: ex.submit(cuda_build.build, name)
                for name in cuda_build.SOURCES}
        res = {name: f.result() for name, f in futs.items()}
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": {name: {"seconds": r["seconds"], "cached": r["cached"],
                              "ptxas": [ln.strip() for ln in
                                        r["log"].splitlines()
                                        if "registers" in ln
                                        or "spill" in ln]}
                       for name, r in res.items()}})
    return res


# ---------------------------------------------------------------------------
# K1 and K2: the poolers

def _agreement(got, ref) -> dict:
    err = (got.float() - ref).abs()
    excess = err - (REL_TOL * ref.abs() + ABS_TOL)
    return {"max_abs_err": float(err.max()),
            "max_abs_ref": float(ref.abs().max()),
            "out_of_tolerance": int((excess > 0).sum()),
            "max_excess_over_tolerance": float(excess.max()),
            "finite": bool(torch.isfinite(got.float()).all())}


def _pool_inputs(g, R: int, edge: bool):
    """Fast profile: levels (B, H, W, C) bf16 and boxes (B, R, 4) f32 on
    the generator's device; the edge batch puts designed boxes first in
    every image."""
    dev = g.device
    feats = tuple(torch.randn((B, TILE // st, TILE // st, C), generator=g,
                              device=dev).to(torch.bfloat16)
                  for st in (4, 8, 16))
    u = torch.rand((B, R, 4), generator=g, device=dev)
    x0, y0 = u[..., 0] * TILE, u[..., 1] * TILE
    w, h = 4 + u[..., 2] * (TILE - 4), 4 + u[..., 3] * (TILE - 4)
    boxes = torch.stack([x0, y0, (x0 + w).clamp(max=TILE),
                         (y0 + h).clamp(max=TILE)], -1)
    if edge:
        special = torch.tensor([
            [0, 0, 0, 0],                  # padded zero box
            [100, 100, 100, 100],          # zero area inside
            [-40, -40, 300, 300],          # beyond every border (P4)
            [250, 250, 290, 300],          # beyond the far corner
            [-20, 100, 10, 140],           # across the left border
            [0, 0, 256, 256],              # whole tile (P4)
            [0, 0, 112, 112],              # level boundary: P3
            [0, 0, 111.9, 111.9],          # just below it: P2
            [10, 10, 234, 234],            # level boundary: P4
            [10, 10, 233.9, 233.9],        # just below it: P3
            [5, 100, 250, 101],            # long and thin
            [100, 5, 101, 250],
            [255, 0, 256, 256],            # last column
            [-1, -1, 0, 0],                # outside the first cell
            [-3, 10, 25, 38],              # a P=7 sample exactly at c = -1
            [231, 10, 259, 38],            # ... and exactly at c = W
            [0, 120, 256, 126],            # full-width road: 64 P2 cells
            [120, 0, 126, 256],            # full-height road
        ], dtype=torch.float32, device=dev)
        k = min(R, len(special))
        boxes[:, :k] = special[:k]
    return feats, boxes.contiguous()


def _parity_pool_inputs(g, R: int, edge: bool):
    """Parity profile: P2..P5 of an 800 px image, bf16, and boxes with
    log-uniform sides from 2 to 800 px (long thin roads included); the edge
    batch puts designed boxes first in every image."""
    dev = g.device
    feats = tuple(torch.randn((PB, s, s, C), generator=g,
                              device=dev).to(torch.bfloat16)
                  for s in PLEVELS)
    u = torch.rand((PB, R, 4), generator=g, device=dev)
    x0, y0 = u[..., 0] * PSIDE, u[..., 1] * PSIDE
    w, h = 2 * 400 ** u[..., 2], 2 * 400 ** u[..., 3]
    boxes = torch.stack([x0, y0, (x0 + w).clamp(max=PSIDE),
                         (y0 + h).clamp(max=PSIDE)], -1)
    if edge:
        S = float(PSIDE)
        special = torch.tensor([
            [0, 0, S, S],                  # the whole image (P5)
            [0, 400, S, 406],              # full-width thin road
            [300, 0, 304, S],              # full-height thin road
            [10, 10, 12, 12],              # 2x2 px
            [0, 0, 0, 0],                  # padded zero boxes
            [0, 0, 0, 0],
            [500, 500, 500, 520],          # zero width
            [-100, -100, 900, 900],        # beyond every border
            [-50, 300, 40, 340],           # across the left border
            [780, 780, 850, 830],          # beyond the far corner
            [-4, 300, 24, 328],            # a P2 sample exactly at c = -1
            [776, 300, 804, 328],          # ... and exactly at c = W
            [300, -4, 328, 24],            # the same along y
            [300, 776, 328, 804],
            [0, 0, 112, 112],              # level boundary: P3
            [0, 0, 111.9, 111.9],          # just below it: P2
            [0, 0, 224, 224],              # level boundary: P4
            [0, 0, 223.9, 223.9],          # just below it: P3
            [0, 0, 448, 448],              # level boundary: P5
            [0, 0, 447.9, 447.9],          # just below it: P4
            [799, 0, 800, 800],            # last column
        ], dtype=torch.float32, device=dev)
        k = min(R, len(special))
        boxes[:, :k] = special[:k]
    return feats, boxes.contiguous()


def _quantized(feats):
    """int8 levels quantized from ``feats`` (one scale a level, max|f|/127,
    as the calibration sets them) and the float32 scales."""
    scales = torch.stack([f.float().abs().amax() / 127.0 for f in feats])
    q = tuple(torch.round(f.float() / s).clamp(-127, 127).to(torch.int8)
              for f, s in zip(feats, scales))
    return q, scales.contiguous()


def _pool_work(feats, boxes, lvl, P: int, s: int):
    """(bytes, FLOPs, box bytes) a pooling call needs: the feature cells
    its boxes' taps touch (each read once, at the levels' element size),
    boxes and levels read, the bf16 output written; box bytes are the
    cells each box touches, summed over the boxes (what a design that
    reads every box's region apart moves, from L2 where boxes overlap).
    FLOPs: the poolers' separable form, for each output bin (p, q) and
    channel, 2 per cell of row p's non-zero y-weights times column q's
    non-zero x-weights, and 2 per non-zero y-weight; int8 levels add 1 per touched cell and channel (its
    dequantization)."""
    from roadsurf_tpu_torch.ops.roi_align_kernel import axis_weights

    item = feats[0].element_size()
    nbytes = boxes.numel() * 4 + lvl.numel() * 4 \
        + boxes.shape[0] * boxes.shape[1] * P * P * C * 2
    flops = 0.0
    box_cells = 0
    for b in range(boxes.shape[0]):      # one image at a time: memory
        ws = axis_weights(tuple(f[b:b + 1] for f in feats), boxes[b:b + 1],
                          lvl[b:b + 1], P, s, 2)
        for wy, wx in ws:
            rows = (wy > 0).any(dim=2).float()                 # (1, R, H)
            cols = ((wx > 0).any(dim=2)
                    & (wy > 0).any(dim=(2, 3))[..., None]).float()
            touched = torch.einsum("brh,brw->bhw", rows, cols) > 0
            nbytes += int(touched.sum()) * C * item
            box_cells += int((rows.sum(-1) * cols.sum(-1)).sum())
            if feats[0].dtype == torch.int8:
                flops += float(touched.sum()) * C
            ny = (wy != 0).sum(-1).float()                     # (1, R, P)
            nx = (wx != 0).sum(-1).float()
            flops += float((ny.sum(-1) * (nx.sum(-1) + P)).sum()) * 2 * C
    return nbytes, flops, box_cells * C * item


def _pool_case(kernel, plain, feats, boxes, P, s, plain_iters: int,
               int8: bool, **meta) -> dict:
    """One pooler call against its plain version, on ``feats`` or, with
    ``int8``, on int8 levels quantized from them."""
    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        reachable_levels

    n_lev = reachable_levels(feats)
    lvl = level_assignment(boxes, 224, 4, 2, 2 + n_lev - 1).contiguous()
    scales = None
    if int8:
        feats, scales = _quantized(feats)
    got = kernel(feats, boxes, lvl, P, s, feat_scales=scales)
    ref = plain(feats, boxes, lvl, P, s, feat_scales=scales)
    torch.cuda.synchronize()
    case = {**meta, "mode": "int8" if int8 else "bf16", "R": boxes.shape[1],
            "P": P, "sampling": s, "C": C, "B": boxes.shape[0],
            "levels": [f.shape[1] for f in feats],
            "boxes_per_level": torch.bincount(
                lvl.flatten(), minlength=n_lev).tolist(),
            **_agreement(got, ref)}
    del ref
    nbytes, flops, box_bytes = _pool_work(feats, boxes, lvl, P, s)
    case.update(
        ms=_time_ms(lambda: kernel(feats, boxes, lvl, P, s,
                                   feat_scales=scales), 20),
        plain_ms=_time_ms(lambda: plain(feats, boxes, lvl, P, s,
                                        feat_scales=scales),
                          plain_iters, warmup=1),
        box_bytes=box_bytes, box_bytes_ms=box_bytes / HBM_BYTES_PER_S * 1e3,
        **_bound(nbytes, flops))
    return case


def phase_kernels_k1(int8: bool) -> list:
    from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused, \
        roi_align_fused_ref

    name = "roi_align_int8" if int8 else "roi_align"
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for edge, poolers in ((False, POOLERS), (True, POOLERS + SPLIT)):
        for pooler, R, P in poolers:
            feats, boxes = _pool_inputs(g, R, edge)
            case = _pool_case(roi_align_fused, roi_align_fused_ref, feats,
                              boxes, P, 2, 5, int8, pooler=pooler,
                              edge=edge, main=not edge)
            _require(case["levels"] == [64, 32, 16]
                     and len(case["boxes_per_level"]) == 3,
                     f"not 3 levels of a 256 px tile: {case}")
            _emit({"phase": "kernels", "kernel": name, **case})
            _require(case["finite"] and case["out_of_tolerance"] == 0,
                     f"{name} disagrees with its plain version: {case}")
            cases.append(case)
    return cases


def phase_kernels_k2(int8: bool) -> list:
    from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
        roi_align_fused_blocked, roi_align_fused_blocked_ref

    name = "roi_align_blocked_int8" if int8 else "roi_align_blocked"
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for edge, poolers in ((False, PPOOLERS), (True, PPOOLERS + PSPLIT)):
        for pooler, R, P, s in poolers:
            feats, boxes = _parity_pool_inputs(g, R, edge)
            case = _pool_case(roi_align_fused_blocked,
                              roi_align_fused_blocked_ref, feats, boxes, P,
                              s, 2, int8, pooler=pooler, edge=edge,
                              main=not edge and s == 0)
            torch.cuda.empty_cache()
            _require(len(case["boxes_per_level"]) == 4,
                     f"not 4 levels at 800 px: {case}")
            _emit({"phase": "kernels", "kernel": name, **case})
            _require(case["finite"] and case["out_of_tolerance"] == 0,
                     f"{name} disagrees with its plain version: {case}")
            cases.append(case)
    return cases


# ---------------------------------------------------------------------------
# K3: the greedy NMS keep mask

def _nms_problems(g, P: int, N: int, side: float):
    """(boxes (P, N, 4), scores (P, N)): boxes in clusters around 40
    centres (overlapping detections of a few objects), bf16-quantized
    scores (ties, as the bf16 RPN logits give)."""
    dev = g.device
    centres = torch.rand((P, 40, 2), generator=g, device=dev) * side
    pick = torch.randint(0, 40, (P, N), generator=g, device=dev)
    c = torch.gather(centres, 1, pick[..., None].expand(P, N, 2)) \
        + torch.randn((P, N, 2), generator=g, device=dev) * side / 100
    half = (0.01 + 0.1 * torch.rand((P, N, 2), generator=g, device=dev)) \
        * side
    boxes = torch.cat([c - half, c + half], -1).clamp(0, side)
    scores = torch.randn((P, N), generator=g, device=dev) \
        .to(torch.bfloat16).float()
    return boxes.contiguous(), scores.contiguous()


def _nms_cases(g):
    """(name, boxes, scores, t), inputs in no particular order."""
    from roadsurf_tpu_torch.ops.nms import NEG_INF

    dev = g.device
    rpn_b, rpn_s = _nms_problems(g, PB * 5, 1000, float(PSIDE))
    rpn_s.view(PB, 5, 1000)[:, 4, 507:] = NEG_INF      # P6: 507 anchors
    cls_b, cls_s = _nms_problems(g, PB, 2000, float(PSIDE))
    # the class-offset trick: class 1's boxes shifted past class 0's
    cls_b[:, 1::2] += PSIDE + 1.0
    n = 1000
    i = torch.arange(n, device=dev, dtype=torch.float32)
    stair = torch.stack([i * 6, torch.zeros_like(i), i * 6 + 10,
                         torch.full_like(i, 10.0)], -1)[None]
    ties_b, _ = _nms_problems(g, 4, 1000, 200.0)
    pad_b, pad_s = _nms_problems(g, 3, 1000, 200.0)
    pad_s[1:] = NEG_INF                                   # all padded
    # the word layout crossed: N not a multiple of 64, one word, and more
    # words than a lane's first slot holds (N > 2048)
    sizes = [(f"n{n}", *_nms_problems(g, 4, n, 200.0), 0.5)
             for n in (1, 63, 64, 65, 130, 3000)]
    return sizes + [
        ("rpn", rpn_b, rpn_s, 0.7),
        ("classes", cls_b, cls_s, 0.5),
        # A kills B, B would kill C: neighbours at IoU 0.25, t 0.2
        ("chain", stair, torch.linspace(1.0, 0.5, n, device=dev)[None], 0.2),
        ("chain_equal_scores", stair, torch.full((1, n), 0.5, device=dev),
         0.2),
        ("equal_scores", ties_b, torch.full((4, 1000), 0.25, device=dev),
         0.5),
        ("padded", pad_b, pad_s, 0.5),
    ]


def _device_ms(fn, iters: int) -> dict:
    """Mean device time of each kernel ``fn`` launches, per call of ``fn``
    (torch.profiler, CUPTI), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out[e.key] = us / 1e3 / iters
    return out


def phase_kernels_k3() -> list:
    from roadsurf_tpu_torch.ops import nms
    from roadsurf_tpu_torch.ops.nms_kernel import nms_keep_mask, \
        nms_keep_mask_ref, pair_phase, row_words, suppression_words, \
        sweep_phase, sweep_words

    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for name, boxes, scores, t in _nms_cases(g):
        order = torch.sort(scores, dim=-1, descending=True,
                           stable=True).indices
        sb = torch.gather(boxes, -2, order[..., None].expand(boxes.shape)
                          ).contiguous()
        ss = torch.gather(scores, -1, order).contiguous()
        got = nms_keep_mask(sb, ss, t)
        ref = nms_keep_mask_ref(sb, ss, t)
        # the pair phase's words bit for bit (rows' words below their own
        # tile, and the padding word, are never written: zeros on both
        # sides), and the plain mirror of the sweep on them
        N = scores.shape[-1]
        words = torch.zeros(ss.shape + (row_words(N),), dtype=torch.int64,
                            device=ss.device)
        pair_phase(sb, ss, t, words)
        mirror = suppression_words(sb, ss, t)
        # the whole exact NMS: on the card (K3) against on the CPU (the
        # plain version)
        ks, ki = nms.nms_fixed(boxes, scores, t, N)
        rs, ri = nms.nms_fixed(boxes.cpu(), scores.cpu(), t, N)
        ks, ki = ks.cpu(), ki.cpu()
        valid = ss > nms.NEG_INF / 2
        case = {"case": name, "main": name in ("rpn", "classes"),
                "problems": scores.numel() // N, "N": N, "iou_thresh": t,
                "mismatches": int((got != ref).sum()),
                "word_mismatches": int((words != mirror).sum()),
                "sweep_mirror_mismatches": int(
                    (sweep_words(mirror, ss) != ref).sum()),
                "nms_fixed_mismatches": int((ks != rs).sum()
                                            + (ki != ri).sum()),
                "kept": int(ref.sum()), "valid": int(valid.sum())}
        # pairs the scan tests: every kept rank against the later valid
        # boxes
        later = valid.sum(-1, keepdim=True) - 1 \
            - torch.arange(N, device=ref.device)
        pairs = float((later.clamp(min=0) * ref).sum())
        nbytes = sb.numel() * 4 + ss.numel() * 4 + ref.numel()
        dev = _device_ms(lambda: sweep_phase(pair_phase(sb, ss, t, words),
                                             ss), 20)
        case.update(
            pair_ms=sum(v for k, v in dev.items() if "nms_pair" in k),
            sweep_ms=sum(v for k, v in dev.items() if "nms_sweep" in k),
            ms=_time_ms(lambda: nms_keep_mask(sb, ss, t), 20),
            plain_ms=_time_ms(lambda: nms_keep_mask_ref(sb, ss, t), 3,
                              warmup=1),
            pairs=pairs, **_bound(nbytes, pairs * PAIR_FLOPS))
        _emit({"phase": "kernels", "kernel": "nms", **case})
        _require(case["mismatches"] == 0
                 and case["nms_fixed_mismatches"] == 0
                 and case["word_mismatches"] == 0
                 and case["sweep_mirror_mismatches"] == 0,
                 f"nms keep mask differs from its plain version: {case}")
        if name == "padded":
            _require(not bool(got[1:].any()), "a padded problem kept a box")
        if name == "chain":
            _require(torch.equal(got[0], torch.arange(
                got.shape[-1], device=got.device) % 2 == 0),
                "the chain did not keep every other box")
        cases.append(case)
    return cases


# ---------------------------------------------------------------------------
# K4: the int8 GEMM

def _gemm_inputs(g, M: int, K: int, N: int, offset: int = 0):
    """a (M, K) and w (K, N) int8, mult and bias (N,) f32 on the
    generator's device; with ``offset``, ``a`` is a contiguous view that
    many bytes into its storage. A unit's epilogue folded into its int8
    consumer's scale: the sums have a spread of about 5400·sqrt(K), so y
    spreads over about ±50 and the int8 mode rounds through its whole
    range."""
    dev = g.device
    a = torch.randint(-127, 128, (M * K + offset,), generator=g, device=dev,
                      dtype=torch.int8)[offset:].view(M, K)
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    mult = (0.5 + torch.rand(N, generator=g, device=dev)) \
        * (50.0 / (5400.0 * K ** 0.5))
    bias = 10.0 * torch.randn(N, generator=g, device=dev)
    return a, w, mult, bias


GEMM_MODES = (("raw", lambda mult, bias: {}),
              ("bf16", lambda mult, bias: {"mult": mult, "bias": bias,
                                           "relu": True}),
              ("int8", lambda mult, bias: {"mult": mult, "bias": bias,
                                           "relu": True, "quantize": True}))


def _gemm_case(kernel, plain, a, w, kw, timed: bool) -> dict:
    """One GEMM call against its plain version, bit for bit; with
    ``timed``, its time, the plain version's, ``torch._int_mm``'s (raw
    mode) and the bound."""
    (M, K), N = a.shape, w.shape[1]
    got = kernel(a, w, **kw)
    ref = plain(a, w, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    case = {"M": M, "K": K, "N": N, "a_offset": a.data_ptr() % 16,
            "max_abs_err": float(diff.max()),
            "mismatches": int((diff > 0).sum()),
            "max_abs_out": float(ref.float().abs().max())}
    if timed:
        raw = "mult" not in kw
        nbytes = M * K + K * N + M * N * got.element_size() \
            + (0 if raw else 8 * N)
        # the device time of the call's kernels (w's transpose, a's
        # padding where needed, the GEMM) beside the call's event time,
        # which also holds the host's launch path
        dev = _device_ms(lambda: kernel(a, w, **kw), 10)
        case.update(
            ms=_time_ms(lambda: kernel(a, w, **kw), 20),
            device_ms=sum(dev.values()),
            transpose_ms=sum(v for k, v in dev.items() if "transpose" in k),
            plain_ms=_time_ms(lambda: plain(a, w, **kw), 3, warmup=1),
            library_ms=_time_ms(lambda: torch._int_mm(a, w), 20)
            if raw else None,
            library_device_ms=sum(_device_ms(
                lambda: torch._int_mm(a, w), 10).values()) if raw else None,
            **_bound(nbytes, 2.0 * M * K * N, INT8_OPS_PER_S))
    return case


def phase_kernels_k4() -> list:
    """Each GEMM shape in the raw, bf16 and int8 epilogue modes, held equal
    to the plain version bit for bit (the integer sum is exact and the
    epilogue rounds each f32 operation as the plain version does), its
    time, the plain version's, ``torch._int_mm``'s for the raw mode, and
    the bound: bytes over the memory rate, 2·M·K·N over the int8
    tensor-core rate; then the ragged shapes of ``GEMM_EDGES``, untimed and
    off the ``kernels`` line's sums, held equal the same way."""
    from roadsurf_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_ref

    g = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(shape, M, K, N, 0, True) for shape, M, K, N in GEMMS] \
        + [(*e, False) for e in GEMM_EDGES]
    cases = []
    for shape, M, K, N, offset, main in shapes:
        a, w, mult, bias = _gemm_inputs(g, M, K, N, offset)
        for mode, kw in GEMM_MODES:
            case = {"case": f"{shape} {mode}", "shape": shape, "mode": mode,
                    "main": main and mode == "raw",
                    **_gemm_case(int8_gemm, int8_gemm_ref, a, w,
                                 kw(mult, bias), main)}
            _emit({"phase": "kernels", "kernel": "int8_gemm", **case})
            _require(case["mismatches"] == 0,
                     f"int8_gemm {mode} differs from its plain version: "
                     f"{case}")
            cases.append(case)
        del a, w
    return cases


# ---------------------------------------------------------------------------
# K5: the poolers' gradient

# training shapes: batch, and the cases (name, side, levels, R, P, s, main):
# the YAML's adaptive poolers at 800 px (box R = min(1024, 1000 + 16), mask
# M = train_mask_rois 128) and the fast profile's fixed s=2 at 256 px
TB = 8
K5_CASES = (("box", 800, (200, 100, 50, 25), 1016, 7, 0, True),
            ("mask", 800, (200, 100, 50, 25), 128, 14, 0, True),
            ("box_s2", 256, (64, 32, 16), 1016, 7, 2, False),
            ("mask_s2", 256, (64, 32, 16), 128, 14, 2, False))
# the plain gradient's batch (its per-image (R, P, W, C) intermediate is
# ~1.5 GB at P2 of 800 px), and K5's tolerance against it on the f32
# gradients: the same weights, sums in another order
K5_CHECK_B = 2
K5_REL, K5_ABS = 1e-5, 1e-6


def _k5_inputs(g, Bn: int, side: int, levels, R: int, P: int, edge: bool):
    """(level shapes, d pooled (Bn, R, P, P, C) bf16, boxes (Bn, R, 4)):
    boxes with log-uniform sides from 2 px to the image side; the edge
    batch puts first in every image boxes on every level, zero (padded GT)
    boxes and boxes on and across the borders."""
    dev = g.device
    shapes = [(Bn, s, s, C) for s in levels]
    dout = torch.randn((Bn, R, P, P, C), generator=g,
                       device=dev).to(torch.bfloat16)
    u = torch.rand((Bn, R, 4), generator=g, device=dev)
    x0, y0 = u[..., 0] * side, u[..., 1] * side
    w = 2 * (side / 2) ** u[..., 2]
    h = 2 * (side / 2) ** u[..., 3]
    boxes = torch.stack([x0, y0, (x0 + w).clamp(max=side),
                         (y0 + h).clamp(max=side)], -1)
    if edge:
        S = float(side)
        special = torch.tensor([
            [0, 0, 0, 0], [0, 0, 0, 0],          # padded GT boxes
            [0, 0, S, S],                        # the whole image
            [0, S / 2, S, S / 2 + 6],            # full-width thin road
            [S / 3, 0, S / 3 + 4, S],            # full-height thin road
            [10, 10, 30, 30],                    # P2
            [20, 20, 140, 140],                  # P3
            [40, 40, 290, 290],                  # P4 (P3 at 256 px)
            [0, 0, 112, 112], [0, 0, 111.9, 111.9],   # level boundaries
            [0, 0, 224, 224], [0, 0, 223.9, 223.9],
            [-50, S / 3, 40, S / 3 + 40],        # across the left border
            [S - 20, S - 20, S + 30, S + 10],    # beyond the far corner
            [S - 1, 0, S, S],                    # the last column
            [-4, 100, 24, 128],                  # a sample exactly at c = -1
        ], dtype=torch.float32, device=dev)
        k = min(R, len(special))
        boxes[:, :k] = special[:k]
    return shapes, dout, boxes.contiguous()


def _k5_work(dout, shapes, boxes, lvl, P: int, s: int) -> tuple:
    """(bytes, FLOPs) the gradient needs: d pooled and the boxes read once,
    each level's bf16 gradient written once; FLOPs of the separable form,
    per box and channel 2·P per non-zero x-weight (the x-contraction) and 2
    per non-zero y-weight and column of the box's region (the
    y-contraction)."""
    from roadsurf_tpu_torch.ops.roi_align_kernel import axis_weights

    grads = sum(int(np.prod(sh)) for sh in shapes)
    nbytes = dout.numel() * 2 + boxes.numel() * 4 + lvl.numel() * 4 \
        + grads * 2
    metas = tuple(torch.empty(sh, device="meta") for sh in shapes)
    flops = 0.0
    for b in range(boxes.shape[0]):
        ws = axis_weights(tuple(m[b:b + 1] for m in metas), boxes[b:b + 1],
                          lvl[b:b + 1], P, s, 2)
        for wy, wx in ws:
            on = (wy != 0).any(dim=(2, 3)).float()              # (1, R)
            nx = (wx != 0).sum(dim=(2, 3)).float() * on         # Σ_q
            ny = (wy != 0).sum(dim=(2, 3)).float()               # Σ_p
            cols = (wx != 0).any(dim=2).sum(-1).float() * on    # region
            flops += float((nx * P + ny * cols).sum()) * 2 * C
    return nbytes, flops


# edges of the histogram of kept boxes a tile
K5_HIST_EDGES = (0, 1, 5, 17, 65, 257)


def _k5_tiles(shapes, boxes, lvl, P: int) -> list:
    """K5's culling replayed (float32, the kernel's tap spans and tiles):
    per level the count of kept boxes of each (image, tile), summarised as
    the tiles, the mean and largest count, and a histogram over
    ``K5_HIST_EDGES`` (the last bin open)."""
    from roadsurf_tpu_torch.ops.roi_align_backward_kernel import TILE_H, \
        tile_w

    TW = tile_w(P)
    x0, y0, x1, y1 = boxes.unbind(-1)
    res = []
    for l, sh in enumerate(shapes):
        H, W = sh[1], sh[2]
        inv = torch.tensor(1.0, device=boxes.device) / 2 ** (2 + l)

        def span(lo, hi, dim):
            binsz = (hi - lo) / P
            a, b = lo, lo + P * binsz   # bin_start(lo, bin, 0), (.., P)
            s0 = torch.floor(torch.minimum(a, b) * inv - 0.5) - 1
            s1 = torch.floor(torch.maximum(a, b) * inv - 0.5) + 2
            return s0.clamp(0, dim - 1), s1.clamp(0, dim - 1)

        sx0, sx1 = span(x0, x1, W)
        sy0, sy1 = span(y0, y1, H)
        on = lvl.clamp(0, len(shapes) - 1) == l
        tx = torch.arange(0, W, TW, device=boxes.device)
        ty = torch.arange(0, H, TILE_H, device=boxes.device)
        kx = (sx0[..., None] < tx + TW) & (sx1[..., None] >= tx)  # B R X
        ky = (sy0[..., None] < ty + TILE_H) & (sy1[..., None] >= ty)
        counts = torch.einsum("brx,bry->byx", (kx & on[..., None]).float(),
                              ky.float()).flatten()
        edges = list(K5_HIST_EDGES) + [float("inf")]
        res.append({"level": l, "tiles": counts.numel(),
                    "tile": [TILE_H, TW],
                    "mean": float(counts.mean()),
                    "max": int(counts.max()),
                    "hist": [int(((counts >= a) & (counts < b)).sum())
                             for a, b in zip(edges, edges[1:])]})
    return res


def phase_kernels_k5() -> list:
    """K5 against its plain version, f32 gradients compared, at B=2 (and
    its bf16 gradients within one bf16 rounding), each launched twice and
    required bitwise equal; then K5 timed at the training batch, B=8,
    beside its plain time and its bound, with the histogram of kept boxes
    a tile."""
    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        reachable_levels
    from roadsurf_tpu_torch.ops.roi_align_backward_kernel import \
        roi_align_backward, roi_align_backward_ref

    g = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for edge in (False, True):
        for name, side, levels, R, P, s, main in K5_CASES:
            shapes, dout, boxes = _k5_inputs(g, K5_CHECK_B, side, levels, R,
                                             P, edge)
            metas = [torch.empty(sh, device="meta") for sh in shapes]
            n_lev = reachable_levels(metas)
            shapes = shapes[:n_lev]
            lvl = level_assignment(boxes, 224, 4, 2, 2 + n_lev - 1) \
                .contiguous()
            got = roi_align_backward(dout, shapes, boxes, lvl, P, s,
                                     dtype=torch.float32)
            got16 = roi_align_backward(dout, shapes, boxes, lvl, P, s)
            again = roi_align_backward(dout, shapes, boxes, lvl, P, s,
                                       dtype=torch.float32)
            again16 = roi_align_backward(dout, shapes, boxes, lvl, P, s)
            ref = roi_align_backward_ref(dout, shapes, boxes, lvl, P, s)
            torch.cuda.synchronize()
            err, err16, bad, bad16, top = 0.0, 0.0, 0, 0, 0.0
            for k, k16, r in zip(got, got16, ref):
                tol = K5_REL * float(r.abs().max()) + K5_ABS
                e = (k - r).abs()
                e16 = (k16.float() - r).abs()
                err, err16 = max(err, float(e.max())), max(err16,
                                                           float(e16.max()))
                top = max(top, float(r.abs().max()))
                bad += int((e > tol).sum())
                bad16 += int((e16 > REL_TOL * r.abs() + tol).sum())
            case = {"pooler": name, "edge": edge, "main": main and not edge,
                    "B_checked": K5_CHECK_B, "R": R, "P": P, "sampling": s,
                    "C": C, "levels": [sh[1] for sh in shapes],
                    "boxes_per_level": torch.bincount(
                        lvl.flatten(), minlength=n_lev).tolist(),
                    "max_abs_err": err, "max_abs_ref": top,
                    "out_of_tolerance": bad, "max_abs_err_bf16": err16,
                    "out_of_tolerance_bf16": bad16,
                    "finite": all(bool(torch.isfinite(k).all())
                                  for k in got),
                    "bitwise_repeatable": all(
                        torch.equal(a, b) for a, b in zip(got + got16,
                                                          again + again16))}
            del got, got16, again, again16, ref
            if not edge:
                # timed at the training batch
                shapes8, dout8, boxes8 = _k5_inputs(g, TB, side, levels, R,
                                                    P, False)
                shapes8 = shapes8[:n_lev]
                lvl8 = level_assignment(boxes8, 224, 4, 2,
                                        2 + n_lev - 1).contiguous()
                nbytes, flops = _k5_work(dout8, shapes8, boxes8, lvl8, P, s)
                case.update(
                    B=TB,
                    ms=_time_ms(lambda: roi_align_backward(
                        dout8, shapes8, boxes8, lvl8, P, s), 10),
                    plain_ms=_time_ms(lambda: roi_align_backward_ref(
                        dout8, shapes8, boxes8, lvl8, P, s), 1, warmup=1),
                    library_ms=None,
                    boxes_a_tile=_k5_tiles(shapes8, boxes8, lvl8, P),
                    **_bound(nbytes, flops))
                del dout8
            torch.cuda.empty_cache()
            _emit({"phase": "kernels", "kernel": "roi_align_backward",
                   **case})
            _require(case["finite"] and case["out_of_tolerance"] == 0
                     and case["out_of_tolerance_bf16"] == 0
                     and case["bitwise_repeatable"],
                     f"roi_align_backward disagrees with its plain version"
                     f" or with itself: {case}")
            cases.append(case)
    _emit({"phase": "kernels", "kernel": "roi_align_backward",
           "case": "autograd", **_pooler_autograd_check(g)})
    return cases


def _pooler_autograd_check(g) -> dict:
    """The training pooler as the step runs it: bf16 channels_last NCHW
    levels (the FPN's) read through NHWC views by ``roi_align_multilevel``
    (K2 forward, K5 backward under ``RoIAlignFunction``), against autograd
    through K2's plain version on float32 copies; the mask pooler's shapes
    at 800 px, B=2, on the edge batch. Forward and gradient each within
    one bf16 rounding of the plain ones."""
    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        roi_align_multilevel
    from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
        roi_align_fused_blocked_ref

    _, levels, R, P, s = K5_CASES[1][1:6]
    shapes, dout, boxes = _k5_inputs(g, K5_CHECK_B, 800, levels, R, P, True)
    xs = [torch.randn((K5_CHECK_B, C, n, n), generator=g, device=g.device)
          .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
          .requires_grad_() for n in levels]
    out = roi_align_multilevel([x.permute(0, 2, 3, 1) for x in xs], boxes,
                               P, sampling=s)
    _require(type(out.grad_fn).__name__ == "RoIAlignFunctionBackward",
             f"the pooler is not under RoIAlignFunction: {out.grad_fn}")
    out.backward(dout)
    xf = [x.detach().float().requires_grad_() for x in xs]
    lvl = level_assignment(boxes, 224, 4, 2, 2 + len(levels) - 1)
    ref = roi_align_fused_blocked_ref(
        tuple(x.permute(0, 2, 3, 1) for x in xf), boxes, lvl.contiguous(),
        P, s)
    ref.backward(dout.float())
    res = {"B": K5_CHECK_B, "R": R, "P": P, "sampling": s,
           "forward": _agreement(out.detach(), ref.detach())}
    bad, err = 0, 0.0
    for x, r in zip(xs, xf):
        e = (x.grad.float() - r.grad).abs()
        tol = REL_TOL * r.grad.abs() + K5_REL * float(r.grad.abs().max()) \
            + K5_ABS
        bad += int((e > tol).sum())
        err = max(err, float(e.max()))
        _require(x.grad.dtype == torch.bfloat16
                 and x.grad.shape == x.shape, "unexpected gradient")
    res.update(grad_max_abs_err=err, grad_out_of_tolerance=bad)
    _require(res["forward"]["out_of_tolerance"] == 0 and bad == 0,
             f"the training pooler disagrees with its plain version: {res}")
    return res


# ---------------------------------------------------------------------------
# main paths

def _random_tree(cfg, gen):
    from roadsurf_tpu_torch.models import init_params

    tree = init_params(cfg, gen)
    # the reference zero-inits the residual branches' FrozenBN scales;
    # give them values so every conv of the backbone computes
    for stage in ("res2", "res3", "res4", "res5"):
        for bp in tree["backbone"][stage]:
            sc = bp["conv3"]["scale"]
            bp["conv3"]["scale"] = 0.1 + 0.2 * torch.rand(sc.shape,
                                                           generator=gen)
    return tree


def _drive(label: str, cfg, batch: int, sizes: list, mask_format: str,
           expect: dict, mask_key: str, mask_shape: tuple):
    """Run ``TileInferenceEngine`` over random 256 px tiles in batches of
    ``sizes`` after one warm-up batch, with every launch count set to 0
    just before; check the launches (``expect``: per batch, every other
    count 0), the outputs and the engine against a direct forward of the
    first and the last (padded) batch. An int8 config is calibrated first,
    as ``bench.py`` calibrates it: ``prepare_quantized`` on 8 random 256 px
    tiles of ``np.random.default_rng(1)``."""
    from roadsurf_tpu_torch.engine import TileInferenceEngine
    from roadsurf_tpu_torch.models import forward_inference, \
        prepare_quantized
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    gen = torch.Generator().manual_seed(0)
    state = from_jax_params(_random_tree(cfg, gen))
    calib_s = None
    if cfg.int8_scope:
        t0 = time.perf_counter()
        cal = np.random.default_rng(1).integers(0, 255, (8, TILE, TILE, 3),
                                                dtype=np.uint8)
        state["quant"] = prepare_quantized(state, cal, cfg)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
    eng = TileInferenceEngine(state, cfg, batch_size=batch,
                              mask_format=mask_format)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (n, TILE, TILE, 3), np.uint8)
               for n in sizes]
    warm = rng.integers(0, 256, (batch, TILE, TILE, 3), np.uint8)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    list(eng.run([warm]))                          # warm-up batch
    stats0 = dict(eng.stats)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outs = list(eng.run(iter(batches)))
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()

    dispatched = 1 + len(batches)
    want = {k: expect.get(k, 0) * dispatched for k in launches}
    _require(launches == want, f"{label}: launches {launches} for "
             f"{dispatched} batches, expected {want}")
    _require([o["valid"].shape[0] for o in outs] == sizes,
             "batch sizes not trimmed back")
    D = cfg.detections_per_image
    n_valid = 0
    for o, n in zip(outs, sizes):
        _require(o["boxes"].shape == (n, D, 4)
                 and o["scores"].shape == (n, D)
                 and o["classes"].shape == (n, D)
                 and o["valid"].shape == (n, D)
                 and o[mask_key].shape == (n, D) + mask_shape,
                 f"unexpected shapes {({k: v.shape for k, v in o.items()})}")
        for k in ("boxes", "scores", mask_key):
            _require(bool(np.isfinite(o[k]).all()), f"{k} not finite")
        _require(bool((o["boxes"] >= 0).all() and (o["boxes"] <= TILE).all()),
                 "boxes outside the tile")
        n_valid += int(o["valid"].sum())
    _require(n_valid > 0, "no valid detection")

    # the engine's pinned slots, side stream and packed fetch against a
    # direct forward of the same (padded) batch: same shapes, same kernels
    engine_max_diff = 0.0
    for i in (0, len(batches) - 1):
        n = sizes[i]
        padded = np.concatenate([batches[i], np.zeros(
            (batch - n, TILE, TILE, 3), np.uint8)])
        ref = forward_inference(eng.state, padded, cfg,
                                mask_format=mask_format)
        for k, v in ref.items():
            r = v.cpu().numpy()[:n]
            _require(outs[i][k].dtype == r.dtype, f"{k}: dtype differs")
            if k in ("valid", "classes", "mask_bits"):
                _require(np.array_equal(outs[i][k], r),
                         f"batch {i} {k}: engine != forward")
            else:
                d = float(np.abs(outs[i][k].astype(np.float64) - r).max())
                engine_max_diff = max(engine_max_diff, d)
    _require(engine_max_diff <= 1e-3,
             f"engine differs from the forward by {engine_max_diff}")
    tiles = sum(sizes)
    ms = start.elapsed_time(end)
    res = {"phase": label, "dtype": cfg.compute_dtype,
           "int8": {"int8_scope": cfg.int8_scope,
                    "int8_pyramid": cfg.int8_pyramid,
                    "calibration_s": calib_s},
           "batch": batch, "input_size": cfg.min_size_test, "batches": sizes,
           "tiles": tiles, "tiles_per_s": tiles / (ms / 1e3),
           "event_ms": ms, "wall_s": wall,
           "h2d_s": eng.stats["h2d_s"] - stats0["h2d_s"],
           "d2h_s": eng.stats["d2h_s"] - stats0["d2h_s"],
           "valid_detections": n_valid, "launches": launches,
           "launches_per_batch": expect,
           "engine_vs_forward_max_abs_diff": engine_max_diff,
           "max_memory_allocated": peak}
    return res, eng, batches


def phase_main_path(int8: bool = False, n_batches: int = 7, tail: int = 40):
    """The fast profile through the engine; with ``int8``, bench.py's
    deployment configuration (int8 full + pyramid): both poolers then read
    the int8 P-levels, K1 in its int8 mode."""
    from dataclasses import replace

    from roadsurf_tpu_torch.models import fast_profile

    cfg = fast_profile(post_nms_topk=32)
    if int8:
        cfg = replace(cfg, **INT8)
    label = "main_path_int8" if int8 else "main_path"
    res, eng, batches = _drive(
        label, cfg, B, [B] * (n_batches - 1) + [tail], "logits",
        {"roi_align_int8" if int8 else "roi_align": 2}, "mask_logits",
        (28, 28))
    res["profile"] = "fast_profile(post_nms_topk=32)" \
        + (f" + {INT8}" if int8 else "")
    _emit(res)
    return res, eng, batches


def phase_main_path_parity(int8: bool = False, n_batches: int = 4,
                           tail: int = 9):
    """The parity profile through the engine (B=16, bits); with ``int8``,
    the same int8 settings as the deployment configuration."""
    from dataclasses import replace

    from roadsurf_tpu_torch.models.config import from_detectron2_yaml

    cfg = from_detectron2_yaml(os.path.join(ROOT, YAML))
    _require((cfg.min_size_test, cfg.pooler_sampling_ratio,
              cfg.rpn_pre_nms_topk_test, cfg.rpn_post_nms_topk_test,
              cfg.detections_per_image, cfg.fast_nms)
             == (PSIDE, 0, 1000, 1000, 100, False),
             f"unexpected parity config {cfg}")
    if int8:
        cfg = replace(cfg, **INT8)
    # per batch: K2 for the box and the mask pooler; K3 once for the
    # RPN's per-level NMS (all five levels in one launch) and once for
    # the class NMS
    label = "main_path_parity_int8" if int8 else "main_path_parity"
    res, eng, batches = _drive(
        label, cfg, PB, [PB] * (n_batches - 1) + [tail], "bits",
        {"roi_align_blocked_int8" if int8 else "roi_align_blocked": 2,
         "nms": 2}, "mask_bits", (98,))
    res["profile"] = f"from_detectron2_yaml({YAML!r})" \
        + (f" + {INT8}" if int8 else "")
    _emit(res)
    return res, eng, batches


def phase_main_path_dense(n_batches: int = 2, tail: int = 40):
    """The dense profile (256 px, fixed 2x2 sampling, exact NMS, 1024
    pre-NMS candidates, 256 proposals, 16 detections) in bf16 through the
    engine at B=64: the one configuration that pairs K1 with K3."""
    from roadsurf_tpu_torch.models import dense_profile

    cfg = dense_profile()
    res, eng, batches = _drive(
        "main_path_dense", cfg, B, [B] * (n_batches - 1) + [tail], "logits",
        {"roi_align": 2, "nms": 2}, "mask_logits", (28, 28))
    res["profile"] = "dense_profile()"
    _emit(res)
    return res, eng, batches


# the host stage: 20 zoom-18 tiles of a 5 x 4 block, x/y of its first tile
HOST_TILES, HOST_X0, HOST_Y0, HOST_COLS = 20, 137150, 92343, 5
ORIGIN_3857 = 20037508.342789244          # pi * 6378137


def _tile_bounds(x: int, y: int, z: int = 18):
    """(west, south, east, north) in EPSG:3857 of web tile z/x/y."""
    ts = 2.0 * ORIGIN_3857 / (1 << z)
    w, n = -ORIGIN_3857 + x * ts, ORIGIN_3857 - y * ts
    return (w, n - ts, w + ts, n)


def _write_host_dataset(wd: str, tree) -> tuple:
    """The tst dataset of ``make_detections`` in ``wd``: HOST_TILES random
    256 px GeoTIFF tiles, the COCO list, ``img_metadata.json`` with their
    bounds, and the weights as ``logs/model_0005999.npz`` (no .pth: run
    takes the .npz beside it). Returns (tiles, bounds)."""
    from roadsurf_tpu_torch.io.geotiff import write_geotiff
    from roadsurf_tpu_torch.utils.weights import save_params

    img_dir = os.path.join(wd, "tst-images")
    os.makedirs(img_dir)
    rng = np.random.default_rng(2)
    tiles = rng.integers(0, 256, (HOST_TILES, TILE, TILE, 3), np.uint8)
    coco, meta, bounds = {"images": []}, {}, []
    for i in range(HOST_TILES):
        x, y = HOST_X0 + i % HOST_COLS, HOST_Y0 + i // HOST_COLS
        fn = f"18_{x}_{y}.tif"
        b = _tile_bounds(x, y)
        write_geotiff(os.path.join(img_dir, fn), tiles[i], b)
        coco["images"].append({"id": i, "file_name": fn, "width": TILE,
                               "height": TILE})
        meta[fn] = {"bounds_3857": list(b)}
        bounds.append(b)
    with open(os.path.join(wd, "COCO_tst.json"), "w") as f:
        json.dump(coco, f)
    with open(os.path.join(wd, "img_metadata.json"), "w") as f:
        json.dump(meta, f)
    save_params(os.path.join(wd, "logs", "model_0005999.npz"), tree)
    return tiles, bounds


# the training path: zoom-18 tiles of the synthetic tileset (train, val),
# x/y of its first tile, steps
TRAIN_TILES, VAL_TILES, TRAIN_X0, TRAIN_Y0 = 24, 8, 137300, 92400
TRAIN_STEPS = 6
# per training step: K2 for the box and the mask pooler's forward, K5 for
# their backward, K3 once for the RPN's per-level NMS (all five levels in
# one launch; training selects its proposals with no class NMS)
STEP_LAUNCHES = {"roi_align_blocked": 2, "roi_align_backward": 2, "nms": 1}


def _road_polygons(rng, n: int) -> list:
    """``n`` thin road-like quadrilaterals (4 to 14 px wide, 40 to 250 px
    long, any direction) as (class 1 or 2, (4, 2) corners clipped to the
    tile)."""
    out = []
    while len(out) < n:
        cx, cy = rng.uniform(0, TILE, 2)
        a = rng.uniform(0, np.pi)
        L, w = rng.uniform(40, 250), rng.uniform(4, 14)
        d = np.array([np.cos(a), np.sin(a)]) * L / 2
        e = np.array([-np.sin(a), np.cos(a)]) * w / 2
        c = np.array([cx, cy])
        quad = np.clip(np.stack([c - d - e, c + d - e, c + d + e,
                                 c - d + e]), 0, TILE)
        if np.ptp(quad[:, 0]) >= 2 and np.ptp(quad[:, 1]) >= 2:
            out.append((int(rng.integers(1, 3)), quad))
    return out


def _write_train_dataset(wd: str) -> dict:
    """The synthetic tileset of ``train_model`` in ``wd``: TRAIN_TILES and
    VAL_TILES zoom-18 256 px GeoTIFF tiles (``trn-images/``,
    ``val-images/``), each with 1 to 6 road polygons of both classes
    painted over noise, and their COCO files. Returns the paths."""
    from roadsurf_tpu_torch.geom import _native
    from roadsurf_tpu_torch.io.geotiff import write_geotiff

    rng = np.random.default_rng(3)
    cats = [{"id": 1, "name": "artificial", "supercategory": "road"},
            {"id": 2, "name": "natural", "supercategory": "road"}]
    paths = {}
    tile = 0
    for ds, n in (("trn", TRAIN_TILES), ("val", VAL_TILES)):
        img_dir = os.path.join(wd, f"{ds}-images")
        os.makedirs(img_dir)
        coco = {"images": [], "annotations": [], "categories": cats}
        for i in range(n):
            x, y = TRAIN_X0 + tile % 8, TRAIN_Y0 + tile // 8
            tile += 1
            fn = f"18_{x}_{y}.tif"
            img = rng.integers(60, 120, (TILE, TILE, 3), np.uint8)
            for cls, quad in _road_polygons(rng, int(rng.integers(1, 7))):
                m = _native.rasterize(_native.pack([[np.concatenate(
                    [quad, quad[:1]])]]), 0.0, 1.0, 0.0, 1.0, TILE, TILE)
                img[m > 0] = (200, 200, 190) if cls == 1 else (150, 110, 60)
                x0, y0 = quad.min(0)
                x1, y1 = quad.max(0)
                coco["annotations"].append({
                    "id": len(coco["annotations"]) + 1, "image_id": i,
                    "category_id": cls,
                    "segmentation": [quad.reshape(-1).tolist()],
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "area": float(m.sum()), "iscrowd": 0})
            write_geotiff(os.path.join(img_dir, fn), img,
                          _tile_bounds(x, y))
            coco["images"].append({"id": i, "file_name": fn, "width": TILE,
                                   "height": TILE})
        paths[ds] = os.path.join(wd, f"COCO_{ds}.json")
        paths[f"{ds}_images"] = img_dir
        with open(paths[ds], "w") as f:
            json.dump(coco, f)
    return paths


def _device_kernels(fn) -> tuple:
    """Run ``fn`` under torch.profiler (CUPTI): ((name, device ms, count)
    of every device kernel, longest first; the wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels.append((e.key, us / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    return kernels, wall * 1e3


def _split(kernels, wall_ms: float) -> dict:
    busy = sum(k[1] for k in kernels)
    cats: dict = {}
    for name, ms, _ in kernels:
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": busy,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "device_ms_by_category": cats,
            "top_kernels": [{"name": k[0][:120], "ms": k[1], "count": k[2]}
                            for k in kernels[:12]]}


def phase_train_path() -> dict:
    """The port's ``train_model``: ``pipeline.training.train`` with the
    YAML's configuration (R50-FPN at full width, multiscale 640..800, B=8,
    adaptive pooler sampling, exact NMS, 16 instances an image) over the
    synthetic tileset, cut to TRAIN_STEPS steps with its eval and its
    checkpoint at the last one, from random weights (there is no ImageNet
    R-50 here). Checks: every step's losses finite; each step's launches
    (STEP_LAUNCHES, every other count 0); ``model_0000005.npz`` in the
    reference's schema, loaded through ``load_params`` and
    ``from_jax_params`` into ``TileInferenceEngine``, which answers a
    batch; the eval's six AP keys finite. Numbers: s/step over steps 2..6
    (CUDA events), images/s, the peak of allocated memory, the eval's
    seconds; then (uncounted) a warm step at each MIN_SIZE_TRAIN size and
    one more at 800 px under torch.profiler."""
    import tempfile
    from dataclasses import replace

    from roadsurf_tpu_torch.engine import TileInferenceEngine
    from roadsurf_tpu_torch.models import init_params
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.ops.cuda_build import BUILD_DIR
    from roadsurf_tpu_torch.pipeline import training
    from roadsurf_tpu_torch.utils.weights import _flatten, from_jax_params, \
        load_params

    cfg = from_detectron2_yaml(os.path.join(ROOT, YAML))
    _require((cfg.min_size_train, cfg.ims_per_batch, cfg.pooler_sampling_ratio,
              cfg.fast_nms, cfg.freeze_at, cfg.compute_dtype)
             == ((640, 672, 704, 736, 768, 800), TB, 0, False, 2,
                 "bfloat16"), f"unexpected training config {cfg}")
    cfg = replace(cfg, max_iter=TRAIN_STEPS, eval_period=TRAIN_STEPS,
                  checkpoint_period=TRAIN_STEPS)
    steps, evals = [], []
    step_fn, eval_fn = training.train_step, training.evaluate_dataset

    def timed_step(cfg_, size):
        fn = step_fn(cfg_, size)

        def run(state, batch):
            torch.cuda.synchronize()
            before = _read_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(state, batch)
            end.record()
            torch.cuda.synchronize()
            after = _read_counts()
            steps.append({"size": size, "ms": start.elapsed_time(end),
                          "launches": {k: after[k] - before[k]
                                       for k in after}})
            return out
        return run

    def timed_eval(*args, **kw):
        t0 = time.perf_counter()
        out = eval_fn(*args, **kw)
        evals.append({"seconds": time.perf_counter() - t0, "ap": out})
        return out

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    training.train_step, training.evaluate_dataset = timed_step, timed_eval
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as wd:
            paths = _write_train_dataset(wd)
            log_dir = os.path.join(wd, "logs")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            state = training.train(
                cfg, paths["trn"], paths["trn_images"], log_dir,
                val_coco=paths["val"], val_images=paths["val_images"],
                max_iter=TRAIN_STEPS, batch_size=TB, image_size=800,
                max_instances=16, log_every=1, seed=7, multiscale=True)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = _read_counts()
            peak = torch.cuda.max_memory_allocated()
            with open(os.path.join(log_dir, "metrics.jsonl")) as f:
                lines = [json.loads(ln) for ln in f]

            # warm steps: a size's first step takes ~0.3 s more than its
            # next ones (the convs' first shapes), and 6 steps over 6
            # sizes are mostly first visits; two steps at every size,
            # the second timed, then one more at 800 px under the profiler
            ds = training.CocoTileDataset(paths["trn"], paths["trn_images"],
                                          16)
            rng = np.random.default_rng(0)
            warm = {}
            for size in cfg.min_size_train:
                batch = training.to_device(training.make_batch(
                    ds, rng, rng.permutation(len(ds))[:TB],
                    target_size=size), "cuda")
                step = step_fn(cfg, size)
                step(state, batch)
                warm[size] = _time_ms(lambda: step(state, batch), 1,
                                      warmup=0)
            kernels, wall = _device_kernels(lambda: step(state, batch))
            prof = _split(kernels, wall)

            # the checkpoint: the reference's schema, and the engine on it
            ckpt = os.path.join(log_dir,
                                f"model_{TRAIN_STEPS - 1:07d}.npz")
            tree, ck_step = load_params(ckpt)
            want = {k: v.shape for k, v in _flatten(init_params(
                cfg, torch.Generator().manual_seed(0))).items()}
            got = {k: v.shape for k, v in _flatten(tree).items()}
            _require(got == want and ck_step == TRAIN_STEPS,
                     f"checkpoint {ckpt} (step {ck_step}) is not in the "
                     f"reference's schema")
            eng = TileInferenceEngine(from_jax_params(tree),
                                      from_detectron2_yaml(
                                          os.path.join(ROOT, YAML)),
                                      batch_size=TB, mask_format="bits")
            val = np.stack([training.CocoTileDataset(
                paths["val"], paths["val_images"], 16).load(i)[0]
                for i in range(TB)])
            out = next(eng.run([val]))
            _require(out["boxes"].shape == (TB, 100, 4)
                     and all(bool(np.isfinite(out[k]).all())
                             for k in ("boxes", "scores")),
                     "the engine on the checkpoint gave no finite answer")
    finally:
        training.train_step, training.evaluate_dataset = step_fn, eval_fn

    losses = [ln for ln in lines if "total" in ln]
    _require(len(losses) == TRAIN_STEPS and all(
        np.isfinite(ln[k]) for ln in losses for k in (
            "loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
            "loss_mask", "total", "lr", "imgs_per_sec")),
        f"losses not finite: {losses}")
    _require(len(steps) == TRAIN_STEPS and all(
        s["launches"] == {k: STEP_LAUNCHES.get(k, 0) for k in s["launches"]}
        for s in steps), f"a step's launches differ from {STEP_LAUNCHES}: "
        f"{[s['launches'] for s in steps]}")
    ap = evals[0]["ap"] if len(evals) == 1 else {}
    _require(sorted(ap) == sorted(f"{t}/{k}" for t in ("bbox", "segm")
                                  for k in ("AP", "AP50", "AP75"))
             and all(np.isfinite(v) for v in ap.values()),
             f"eval: {evals}")
    timed = [s["ms"] for s in steps[1:]]
    s_step = float(np.mean(timed)) / 1e3
    res = {"phase": "train_path",
           "profile": f"from_detectron2_yaml({YAML!r}), multiscale "
                      f"{list(cfg.min_size_train)}",
           "reduced": {"max_iter": TRAIN_STEPS,
                       "eval_period": TRAIN_STEPS,
                       "checkpoint_period": TRAIN_STEPS,
                       "weights": "random (init_params, seed 7)",
                       "tiles": {"trn": TRAIN_TILES, "val": VAL_TILES}},
           "batch": TB, "run_s": run_s, "steps": steps,
           "s_per_step": s_step, "images_per_s": TB / s_step,
           "warm_ms_by_size": warm,
           "warm_s_per_step": float(np.mean(list(warm.values()))) / 1e3,
           "warm_images_per_s": TB / (float(np.mean(list(warm.values())))
                                      / 1e3),
           "max_memory_allocated": peak, "launches": launches,
           "launches_per_step": STEP_LAUNCHES,
           "losses": losses, "eval": {"seconds": evals[0]["seconds"],
                                      "ap": ap},
           "checkpoint": os.path.basename(ckpt),
           "profile_step": prof}
    _emit(res)
    return res


def _host_profile(fn) -> dict:
    """Share of ``fn``'s host time by step (cProfile, inclusive times of
    the steps' functions; cProfile adds cost to Python calls, not to
    native code)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    steps = {"paste_masks": "paste_masks", "trace (C++)": "trace_mask",
             "rdp_simplify": "rdp_simplify",
             "hole assignment (_point_in_ring)": "_point_in_ring",
             "mask_to_polygons": "mask_to_polygons"}
    st = pstats.Stats(prof).stats
    out = {"profiled_s": wall}
    for step, name in steps.items():
        cum = sum(v[3] for (_, _, func), v in st.items() if func == name)
        out[step] = cum
    return out


def phase_host_stage():
    """The port's ``make_detections`` end to end: the YAML block of
    config/config_obj_detec.yaml through ``pipeline.detections.run`` over
    HOST_TILES GeoTIFF tiles (the parity profile in bf16 at full width,
    bits masks, B=16: batches of 16 and 4), weights from the .npz beside
    the pinned .pth name; then the gpkg's checks, and the records of the
    first 4 tiles against the per-image host stage run on a direct
    ``forward_inference`` of the first batch."""
    import sqlite3
    import tempfile

    from roadsurf_tpu_torch.crs import transform_xy
    from roadsurf_tpu_torch.geom.table import DetectionTable
    from roadsurf_tpu_torch.io import wkb
    from roadsurf_tpu_torch.models import forward_inference
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.ops.cuda_build import BUILD_DIR
    from roadsurf_tpu_torch.pipeline import detections
    from roadsurf_tpu_torch.utils.config import load_script_config
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    model_cfg = from_detectron2_yaml(os.path.join(ROOT, YAML))
    tree = _random_tree(model_cfg, torch.Generator().manual_seed(0))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as wd:
        tiles, bounds = _write_host_dataset(wd, tree)
        cfg = dict(load_script_config(
            os.path.join(ROOT, "config", "config_obj_detec.yaml"),
            "make_detections.py"), working_directory=wd,
            detectron2_config_file=os.path.join(ROOT, YAML))
        merges = []
        merge = detections.merge_params

        def recording_merge(init, loaded):
            merged, skipped = merge(init, loaded)
            merges.append(skipped)
            return merged, skipped

        stats = {}
        detections.merge_params = recording_merge
        try:
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            files = detections.run(cfg, batch_size=PB, stats=stats)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = _read_counts()
        finally:
            detections.merge_params = merge
        _require(merges == [[]], f"host_stage: merge skipped {merges}")
        n_batches = -(-HOST_TILES // PB)
        expect = {"roi_align_blocked": 2, "nms": 2}
        want = {k: expect.get(k, 0) * n_batches for k in launches}
        _require(launches == want, f"host_stage: launches {launches}, "
                 f"expected {want}")
        _require([os.path.basename(f) for f in files]
                 == ["tst_detections_at_0dot05_threshold.gpkg"],
                 f"host_stage wrote {files}")
        gpkg = files[0]
        gpkg_bytes = os.path.getsize(gpkg)
        con = sqlite3.connect(gpkg)
        try:
            layers = con.execute(
                "SELECT table_name, column_name, geometry_type_name, srs_id"
                " FROM gpkg_geometry_columns").fetchall()
            contents = con.execute(
                "SELECT table_name, srs_id FROM gpkg_contents").fetchall()
            sql = con.execute("SELECT sql FROM sqlite_master WHERE name = "
                              "'tst_detections'").fetchone()[0]
            rows = con.execute("SELECT geom, score, det_class FROM "
                               "tst_detections ORDER BY fid").fetchall()
        finally:
            con.close()
        _require(layers == [("tst_detections", "geom", "POLYGON", 4326)]
                 and contents == [("tst_detections", 4326)],
                 f"gpkg layers {layers}, contents {contents}")
        _require('"score" REAL' in sql and '"det_class" INTEGER' in sql,
                 f"gpkg columns: {sql}")
        _require(len(rows) > 0, "host_stage wrote no record")
        _require(all(c in (0, 1) for _, _, c in rows), "det_class not 0/1")
        _require(all(0.05 <= s <= 1.0 for _, s, _ in rows),
                 "a score outside [0.05, 1]")
        # every envelope (GPB header: minx, maxx, miny, maxy) inside the
        # tiles' lon/lat box, one pixel of slack
        w, s = bounds[HOST_TILES - HOST_COLS][0], bounds[-1][1]
        e, n = bounds[HOST_COLS - 1][2], bounds[0][3]
        (x0, x1), (y0, y1) = transform_xy(3857, 4326, [w, e], [s, n])
        px = (x1 - x0) / (HOST_COLS * TILE)
        envs = np.array([struct.unpack_from("<4d", g, 8) for g, _, _ in rows])
        _require(bool((envs[:, 0] >= x0 - px).all()
                      and (envs[:, 1] <= x1 + px).all()
                      and (envs[:, 2] >= y0 - px).all()
                      and (envs[:, 3] <= y1 + px).all()),
                 "an envelope outside the tiles")

        # the host stage against the forward: the first batch as the
        # engine ran it, then the per-image host stage of its first 4
        # tiles, one image at a time
        state = from_jax_params(tree)
        dets = {k: v.cpu().numpy() for k, v in forward_inference(
            state, tiles[:PB], model_cfg, mask_format="bits").items()}
        direct = []
        host = _host_profile(lambda: direct.extend(
            r for bi in range(4)
            for r in detections.vectorize_one(dets, bi, bounds[bi])))
        ref = DetectionTable.from_records(direct, 3857).to_crs(4326)
        got = rows[:len(ref)]
        same = len(ref) > 0 and all(
            g[40:] == wkb.dumps(p) and sc == float(s_) and c == int(c_)
            for (g, sc, c), p, s_, c_ in zip(got, ref.geometry, ref.score,
                                             ref.det_class))
        _require(same, f"the first 4 tiles' {len(ref)} records differ from "
                 "the per-image host stage of a direct forward")
        # where the host time goes without the pool: the first batch's
        # host stage in one thread
        t0 = time.perf_counter()
        for bi in range(PB):
            detections.vectorize_one(dets, bi, bounds[bi])
        serial_s = time.perf_counter() - t0
        # the same run again, warm (tracer built, kernels loaded), uncounted
        warm = {}
        detections.run(cfg, batch_size=PB, stats=warm)
    res = {"phase": "host_stage", "tiles": stats["tiles"],
           "batches": [min(PB, HOST_TILES - i)
                       for i in range(0, HOST_TILES, PB)],
           "profile": f"from_detectron2_yaml({YAML!r}), bits",
           "run_s": run_s, "wall_s": stats["wall_s"],
           "tiles_per_s": stats["tiles"] / stats["wall_s"],
           "decode_s": stats["decode_s"],
           "vectorize_thread_s": stats["vectorize_s"],
           "h2d_s": stats["h2d_s"], "d2h_s": stats["d2h_s"],
           "detections": stats["detections"], "records": stats["records"],
           "gpkg_bytes": gpkg_bytes, "launches": launches,
           "launches_per_batch": expect,
           "first_4_tiles_records_equal": len(ref),
           "host_profile_4_tiles": host,
           f"serial_host_stage_s_{PB}_tiles": serial_s,
           "warm": {"wall_s": warm["wall_s"],
                    "tiles_per_s": warm["tiles"] / warm["wall_s"],
                    "decode_s": warm["decode_s"],
                    "vectorize_thread_s": warm["vectorize_s"],
                    "h2d_s": warm["h2d_s"], "d2h_s": warm["d2h_s"],
                    "records": warm["records"]}}
    _emit(res)
    return res


def _category(name: str) -> str:
    n = name.lower()
    # K1 and K2 run one device code (roi_align_staged_kernel): on the fast
    # paths "roi_align" is K1, on the parity and training paths K2; K5 is
    # roi_align_backward_tile_kernel
    for cat, keys in (("roi_align_backward", ("roi_align_backward",)),
                      ("roi_align", ("roi_align",)),
                      ("nms", ("nms",)),
                      ("conv", ("conv", "xmma", "implicit", "cudnn",
                                "nhwc", "winograd")),
                      ("gemm", ("gemm", "cutlass", "cublas", "matmul")),
                      ("sort/top-k", ("sort", "radix", "topk")),
                      ("copy", ("memcpy", "memset", "copy"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def phase_profile(label: str, eng, batches, n: int = 2) -> dict:
    """Device time by kernel over ``n`` steady batches of a main path
    (torch.profiler, CUPTI), and the device's busy share of the wall."""
    kernels, wall = _device_kernels(lambda: list(eng.run(iter(batches[:n]))))
    res = {"phase": "profile", "path": label, "batches": n,
           "tiles": sum(len(b) for b in batches[:n]), **_split(kernels, wall)}
    _emit(res)
    return res


def _toolchain() -> dict:
    from importlib import metadata

    from roadsurf_tpu_torch.ops.cuda_build import nvcc_path

    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    try:
        triton = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton = None
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "triton": triton,
            "nvcc": next((ln.strip() for ln in out.splitlines()
                          if "release" in ln), out.strip())}


def _record(name, source, replaces, launches, cases, err_key, per_key):
    """One entry of the ``kernels`` line: a forward's calls of the kernel
    (the cases at the main path's shapes, summed) beside their bound, plain
    time and library time; the error over every case. ``launches``:
    {path: count} of the main paths that ran."""
    timed = [c for c in cases if c["main"]]
    t_bytes = sum(c["bytes_ms"] for c in timed)
    t_ops = sum(c["ops_ms"] for c in timed)
    lib = [c.get("library_ms") for c in timed]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(c[err_key] for c in cases),
            "ms": sum(c["ms"] for c in timed),
            "plain_ms": sum(c["plain_ms"] for c in timed),
            "bound_ms": sum(c["bound_ms"] for c in timed),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(lib) if lib and None not in lib else None,
            # K2: the bytes a per-box design moves; K3: its two phases; K4:
            # the device time of its kernels and of torch._int_mm's
            **{k: sum(c[k] for c in timed) for k in (
                "box_bytes", "box_bytes_ms", "pair_ms", "sweep_ms",
                "device_ms", "transpose_ms", "library_device_ms")
               if timed and k in timed[0]},
            "per_call": {c[per_key]: {k: c.get(k) for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "box_bytes_ms", "pair_ms", "sweep_ms", "device_ms",
                "transpose_ms", "library_device_ms") if k in c}
                for c in timed}}


PATHS = ("main_path", "main_path_parity", "main_path_int8",
         "main_path_parity_int8")
# kernel entry -> (source, TPU kernel it replaces, count name); K1 runs on
# the fast paths and the dense one, K2 on the parity paths and the host
# stage, K3 on those and the dense path, K4 on none
KERNELS = {
    "roi_align": ("roi_align.cu", "roi_align_pallas.py:638", "roi_align"),
    "roi_align_int8": ("roi_align.cu", "roi_align_pallas.py:638",
                       "roi_align_int8"),
    "roi_align_blocked": ("roi_align_blocked.cu", "roi_align_pallas.py:471",
                          "roi_align_blocked"),
    "roi_align_blocked_int8": ("roi_align_blocked.cu",
                               "roi_align_pallas.py:471",
                               "roi_align_blocked_int8"),
    "nms": ("nms.cu", "nms_pallas.py:59", "nms"),
    "int8_gemm": ("int8_gemm.cu", "int8_gemm.py:79", "int8_gemm"),
    # no Pallas kernel: the reference takes this gradient from XLA's
    # autodiff of its separable pooler
    "roi_align_backward": ("roi_align_backward.cu", "roi_align.py:318",
                           "roi_align_backward"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import roadsurf_tpu_torch  # noqa: F401  (fails outside the repository)

    # the plain versions are the references: their f32 products in full
    # f32, not TF32 (the bf16 paths compute in bf16 either way; the int8
    # paths' integer products take TF32 themselves, exactly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    _emit({"phase": "toolchain", **_toolchain(), "card": smi})
    phase_build()
    cases = {"roi_align": phase_kernels_k1(int8=False),
             "roi_align_int8": phase_kernels_k1(int8=True),
             "roi_align_blocked": phase_kernels_k2(int8=False),
             "roi_align_blocked_int8": phase_kernels_k2(int8=True),
             # K3's error is the count of keep flags unlike the plain
             # version's
             "nms": [dict(c, max_abs_err=c["mismatches"])
                     for c in phase_kernels_k3()],
             "int8_gemm": phase_kernels_k4(),
             "roi_align_backward": phase_kernels_k5()}
    runs = {}
    for label in PATHS:
        fn = phase_main_path_parity if "parity" in label \
            else phase_main_path
        res, eng, batches = fn(int8=label.endswith("int8"))
        phase_profile(label, eng, batches)
        runs[label] = res
        del eng, batches
        torch.cuda.empty_cache()
    res, eng, batches = phase_main_path_dense()
    phase_profile("main_path_dense", eng, batches)
    runs["main_path_dense"] = res
    del eng, batches
    torch.cuda.empty_cache()
    runs["host_stage"] = phase_host_stage()
    torch.cuda.empty_cache()
    runs["train_path"] = phase_train_path()

    # the times are one forward's calls at the main paths' shapes: both
    # poolers (K2 at its adaptive sampling), the RPN's and the class NMS
    # (K3); K4's are its raw GEMMs at the int8 stack's 1x1 and box FC1
    # shapes; K5's one training step's, box and mask poolers at B=8
    _emit({"kernels": [
        _record(name, "roadsurf_tpu_torch/csrc/" + src,
                "roadsurf_tpu/ops/" + tpu,
                {p: r["launches"][count] for p, r in runs.items()
                 if r["launches"][count]},
                cases[name], "max_abs_err",
                "case" if name in ("nms", "int8_gemm") else "pooler")
        for name, (src, tpu, count) in KERNELS.items()]})
    print(smi)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
