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
   shapes, on int8 levels quantized from those (one scale a level), and in
   their float32 mode, on float32 noise of the same draws, not rounded
   (float32 out, held at <= 1e-5·max|plain| + 1e-6, a tolerance the plain
   version on the levels rounded to bf16 must fail); beside
   the byte bound each K2 case reports ``box_bytes``, the cells each box
   touches summed over the boxes, and edge batches also cross K2's work
   split (R of 37 and 13, a row wider than a staged chunk, a short last
   band of output rows, P = 28's four columns a warp). K1's int8 mode
   also on four levels, P5's 8×8×C block included, with boxes whose level
   is P5 (``P5_POOLERS``: the reference's int8-pyramid check; its blocked
   check's fixed s=2 on the parity shapes is K2's ``box_s2``). K3
   (``nms``): the
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
   histogram of kept boxes per tile and level (``_k5_tiles``); then again
   from a float32 d pooled (the float32 profiles' training; float32
   noise, not rounded), float32 gradients only, where the plain gradient
   of the d pooled rounded to bf16 must fail the tolerance. K6
   (``bias_act``, the conv epilogue): every call of one bf16 inference
   forward of the parity profile (B=16, 800 px) and of the fast profile
   (B=64), random weights with drawn biases, each held equal bit for bit
   to its plain version on the same inputs (``EPILOGUE`` = 77 calls a
   forward, no conv through the plain ops); the parity forward's calls
   timed beside their plain version and their byte bound; and
   ``K6_EDGES`` (C of 3, 12 and 20, odd sides, NaN, ±0, ±inf and a
   subnormal among the values), bit for bit. K7 (``rel_attention``,
   ViTDet's attention): every call of one ViTDet-B bf16 forward (B=16
   tiles at 1024 px: 8 windowed blocks of 25 windows of 196 tokens an
   image, 4 global over 4096; ``K7_LAUNCHES`` = 12) on the benchmark
   family's seeded weights, each held within ``_k7_tolerance`` of its
   plain version on the same inputs, no call through the plain version,
   and one call of each kind timed beside its plain version and its
   bound; then both shapes on unit normals with relative-position tables
   of std 1 (terms of ~8 in the scores). K8 (``layer_norm``, ViTDet's
   LayerNorms with the residual sum, the window pad and the ReLU or GELU
   beside them): every LN call of one ViTDet-B bf16 forward at B=16
   (``K8_LAUNCHES`` = 41: 24 in the blocks, 9 in the pyramid, 8 in the
   heads), the residual sum bit for bit, the LN within 2⁻⁸·|plain| + 1e-4
   of its plain version in float32, the pad's bits zero, no call through
   the plain version; one call of each shape and mode timed beside its
   plain version and its byte bound (at the ViT's 4096 × 768 rows at least
   ``K8_FLOOR`` of it); then ``K8_EDGES`` (ragged row counts and pads,
   constant rows, C of 8, 24 and 1024).
3. ``main_path``: the fast profile (R50-FPN at full width, bf16, random
   weights from a seed) through ``TileInferenceEngine.run`` over batches of
   64 random 256 px tiles, the last one short; K1 must have been launched
   twice per batch and K6 77 times (every bf16 inference path: the conv
   epilogue of each conv, none through the plain ops, ``_plain_convs``),
   and the outputs must be finite, of the right shapes,
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
12. ``tileset_path``: the user's chain that makes a training set, on the
   card's host, then training on what it wrote. ``write_scene`` builds a
   synthetic swissTLM3D scene with the port's writers (a GRID x GRID
   jittered road grid 150 m apart, its ~760 two-node segments the roads,
   OBJEKTART 2, 9, 20 and 21, ~3% of unknown surface, covered bridges
   filtered out; ten forests; a 3 km x 3 km AOI); ``pipeline.label_prep.
   run`` and ``pipeline.tilesets.run`` take the YAML's blocks, the tiles
   served as PNG bytes (``png_bytes``, every row Up-filtered) cut from one
   z18 mosaic (``MosaicOpener``: noise, the ground truth filled in a colour
   a category by ``geom_rasterize``). Checks: GT plus OTH labels equal the
   labelled roads; every tile has its GeoTIFF in ``{ds}-images/`` and
   ``all-images/``, pixels equal to what was served (the PNG decode needs
   no Pillow) and ``img_metadata.json`` bounds equal to ``xy_bounds``;
   every COCO ring in [0, 256] with at least 6 values; ``labels_id.json``
   through ``pd.read_json(orient="index")``. Then ``pipeline.training.
   train`` 2 steps on ``COCO_trn.json`` (the YAML's model at full width,
   B=8, multiscale, no eval): finite losses, STEP_LAUNCHES a step. Its
   line holds each stage's seconds, the counts and the tiles written a
   second.
13. ``dp_train``: the data-parallel training step (``parallel/``,
   ``engine/train.py`` with a group): two gloo ranks sharing cuda:0
   (NCCL takes one rank a device; the card computes, gloo carries the
   collectives) against one rank, the YAML's model at full width in
   float32 (K2 and K5 in their float32 modes) with TF32 off, fixed 320
   px, a global batch of 4, 2 steps.
   Checks: each step's losses within 1e-4 + 1e-3·|ref|, the ranks'
   parameters bitwise equal, a rank's step FLOPs at most 1.35/2 of the
   one-rank step's, every rank's K2 2, K5 2 and K3 1 launches a step.
14. ``dp_train_run``: ``pipeline.training.run`` data-parallel over every
   card with NCCL (one rank a card) on the ``train_model.py`` block over
   train_path's synthetic tileset, bf16, multiscale 640..800, B=8, 3
   steps: finite losses, each rank's launches, one checkpoint that the
   engine loads and answers from; host s/step beside train_path's, and
   the loader's seconds a global batch.
15. ``dp_infer``: the sharded ``TileInferenceEngine`` (every card, or two
   shards on cuda:0 when there is one), the parity profile in float32,
   B=16: its outputs equal bit for bit to a one-device engine's at the
   shard's batch size on the same rows, K2 (float32) and K3 twice a
   shard and batch; beside it, the differences of both from the
   one-device engine at B=16 (random weights: near-equal scores may
   reorder), and tiles/s of the three.
16. ``scan_path``: the multi-batch dispatch, CUDA graphs that replay the
   kernels (``utils/graphs.py``), one line a part. (a) The fast profile
   (bf16, B=64, ``main_path``'s weights and tiles) through
   ``TileInferenceEngine`` at ``scan_k`` 16 (bench.py's k) and at 1: the
   outputs bit for bit equal, K1 twice for every batch a group runs (the
   tail group's empty batches included); tiles/s over 32 full batches
   (CUDA events); over one group (16 batches) the device split and busy
   share (torch.profiler) and K1's launches read from the kernel names,
   equal to the counters' (2 x k); the graph's capture seconds and
   memory pool. (b) The parity profile (bf16, B=16, bits) at 4 and 1,
   the same checks with K2 and K3 twice a batch. (c) The sharded engine
   (two replicas on cuda:0, fast, B=64) at scan_k 4, bit for bit equal to
   one device's at the shard's batch. (d) ``make_train_scan_step`` (the
   YAML's model, bf16, 800 px, B=8, k=4) against 4 single steps from
   copies of one state with the same draws, under
   ``cudnn.deterministic``: parameters, velocity and the last metrics bit
   for bit (else the training step tests' tolerances, with the eager
   steps' own repeatability beside them), twice; s/step of both, and a
   scan's K2 8, K5 8 and K3 4 launches from the profiler and the
   counters.
17. ``f32_forward``: the fast and the parity profile in float32 (random
   weights, the CPU tests' narrow heads, TF32 off) through
   ``forward_inference`` on 4 and 2 tiles, through the kernels (K1; K2
   and K3) and through their plain versions: valid flags and classes
   equal, boxes within 1e-4 px, mask logits within 1e-4·max(1,
   max|logit| / 6.4).
18. ``quality_path``: the first runs with weights trained on the card.
   ``tools.learning_smoke`` (500 steps from scratch on synthetic
   rectangles, 64 px, B=16; gates: the last 50 steps' mean total below
   0.2x the first step's and below 1.0, at least 12 of 16 instances
   found; its control, 51 steps with the weights held at their init,
   must end above 0.2x), then
   ``tools.quality`` (label preparation, tilesets from a synthetic tile
   service, 600 training steps at B=8 on 256 px tiles, the validation
   AP, make_detections with the checkpoint and final metrics under the
   fast and the exact profile; gate: each profile's balanced F1 at
   least 0.15 over the baseline's). K1, K3 and K5 must have run. Its
   workdir stays for the next phase.
19. ``ablation_path``: in ``quality_path``'s workdir (the scene reused),
   ``tools.ablate_seeded`` scores seed 0 under fast-R32+int8pyr (gate: its
   F1 at least 0.15 over the baseline's), seed 0 being ``quality_path``'s
   checkpoint (the same recipe, ``quality_config(600)``: the seed's
   training resumes there and takes no step, and the phase fails if it
   wrote a checkpoint or a metrics line; the tool's own command trains
   its seeds from scratch and scores the script's other variants,
   parity800 and parity800+int8pyr among them); ``tools.ablate_mask_bits``
   scores it with the u8 and the bits mask downlink (gate: |delta F1| <= 0.02); ``tools.measure_detections``
   runs make_detections over 256 copies of the training tiles at B=256
   with that checkpoint (its inputs scaled as it was trained), at scan_k
   1 (profiled), 4 and on the int8 stack
   (gates: records > 0; scan_k 4's records equal to scan_k 1's). K1 in
   bf16 and int8 must have run.
19b. ``measure_path``: each profile and microbenchmark of ``tools/``
   (the reference's ``profile_*`` and ``bench_*`` scripts) once at one
   step and a cut batch: ``profile_stages`` on the fast profile at B=64
   in bf16 and on the int8 stack, whose FULL row must equal the engine's
   output bit for bit; ``profile_heads``, ``profile_proposals`` and
   ``bench_proposals`` at B=64; ``bench_training`` (the YAML's model at
   256 px, B=8, scan_k 4: a CUDA graph of 4 steps; gates: finite loss,
   0 < MFU <= 1) and ``profile_training`` at B=4; ``bench_pooler``,
   ``bench_int8_gemm`` and ``bench_conv_dtypes`` at B=64 (2 calls a
   step), ``bench_pooler_variants`` at B=64 (K1's kernel built stopped
   after each of its phases, three libraries of their own, built
   together; not kernels of the port). Then the kept engine of ``pipeline.detections.detect_tiles``:
   two calls at scan_k 4 over 8 tiles with other weights each; the second
   captures no graph (``CapturedGraph.captures``), its records are a
   fresh engine's and differ from the first call's.
19c. ``bench_path``: ``tools/bench.py``, the port of the reference's
   ``bench.py``, at each of its four settings at its own batch and k, two
   timed steps each (the least at which a second input copy and replay
   are enqueued before the first step's scalar is fetched): fast int8 (its default: ``fast_profile(
   post_nms_topk=32)``, int8 full scope with the int8 pyramid, B=512,
   k=16), fast bf16 (``BENCH_INT8=0``), parity int8 (``BENCH_PROFILE=
   parity``, B=16, k=4) and parity bf16, each inside the CUDA graph of k
   forwards that ``make_inference_scan_fn`` captures. Gates: the launches
   over the measurement (the capture's warm-up forwards and every replay:
   K1 in the fast cells' mode, K2 in the parity cells' and K3, twice a
   forward each); each step's lag-1 scalar (its score sum, fetched one
   step late) equal bit for bit to the sum from replaying that step's
   batch alone afterwards, and finite; over that replay, the launches read
   from the kernels' names (torch.profiler) equal to the counters'. Each
   cell's line holds tiles/s, host seconds, event ms a step, the capture's
   seconds and memory pool, the input copy's ms and the peak memory. Then
   ``roadsurf_tpu_torch.entry.entry()``'s forward on its own arguments:
   the reference's output keys and shapes, finite, K1 twice.
20. ``cog_path``: the tif2cog device stages on a SWISSIMAGE-RS-sized
   image (10000² × 4 uint16, EPSG:2056, a nodata border): the host's
   inverse map, the gather (equal to numpy's of the same indices),
   ``band_stats`` (min/max equal, mean/std rtol 1e-5 of float64 numpy),
   ``scale_to_byte`` (equal to its CPU version), each timed; then
   ``Tif2Cog.run`` over a ``LocalStore`` on three 2000² images: steps
   1-3, a rerun that skips, COGs in EPSG:3857 with 8 overviews.
21. ``stats_path``: the statistical branch, config/config_stats.yaml's
   chain (``stats_chain``) on ``write_scene``'s grid: ``pipeline.
   stats_prep`` (the overlap-free road polygons, the restricted AOI),
   ``pipeline.label_prep`` (the tiles over them), ``pipeline.tilesets``
   (4-band TIFF tiles, R, G, B and NIR, from ``BandsOpener``; the YAML's
   debug cap of 100 tiles) and ``pipeline.stats_analysis`` (KS tests on,
   the PCAs on the card; without matplotlib no figure, the PCAs' tables
   alone), then ``assess --statistics``, the DEM chain (``tiles.
   rasters.run`` over nine synthetic 1 km² DEM tiles at 2 m from a local
   opener), the sandbox tools and ``upload.run`` twice into a
   ``LocalStore``. Checks: no road polygons overlapping by more than 1 m²;
   the restricted AOI against ``aoi_oracle`` (1 m pixels, within 1% of its
   area, a hole for each field no forest reaches); pixel rows equal to the
   masks' pixel counts; each PCA on the card equal to its CPU run within
   1e-9·max|value| (also on the pixel frame repeated to 3.7 M rows, both
   timed); each road the analysis repairs with buffer(0) (invalid once
   reprojected to EPSG:3857) covering the points its own fill covers; the
   DEM statistics equal to numpy's over the same masks; the
   limiter, the corrections and the tile masks against brute force and the
   roads' fill; the second upload skipping every file; every file the
   YAML promises written. Its line holds each stage's seconds, the pixel
   rows and features, the PCA's seconds on the card and on the CPU, the
   counts and whether matplotlib is importable.

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
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores (data sheet)
# |kernel - plain| <= 2^-8·|plain| + 1e-4, for K1 and K2: one bf16 rounding
# of the output (half an ulp, at most 2^-9 relative) over f32 sums taken in
# another order (the kernels wy·Σ wx·f per row, the plain versions
# (Σ wy·f)·wx): a few ulps of Σ|w·f| ≤ max |f| ~ 5, ~1e-5. The
# weights themselves, and so every sample's border decision, are computed
# with the same operations in both. A misplaced sample costs ~1e-1.
REL_TOL, ABS_TOL = 2.0 ** -8, 1e-4
# float32 levels (K1, K2) and a float32 d pooled (K5): |kernel - plain| <=
# 1e-5·max|plain| + 1e-6, no output rounding, f32 sums in another order
F32_REL, F32_ABS = 1e-5, 1e-6
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


def _reset_counts():
    from roadsurf_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def _read_counts() -> dict:
    from roadsurf_tpu_torch.ops import launch_counts

    return launch_counts()


def _sum_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


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
    """Agreement of a pooler's output with its plain version's: within one
    bf16 rounding for bf16 output, within F32_REL of the plain version's
    largest value for float32 output."""
    err = (got.float() - ref).abs()
    tol = F32_REL * float(ref.abs().max()) + F32_ABS \
        if got.dtype == torch.float32 else REL_TOL * ref.abs() + ABS_TOL
    excess = err - tol
    return {"max_abs_err": float(err.max()),
            "max_abs_ref": float(ref.abs().max()),
            "out_of_tolerance": int((excess > 0).sum()),
            "max_excess_over_tolerance": float(excess.max()),
            "finite": bool(torch.isfinite(got.float()).all())}


def _pool_inputs(g, R: int, edge: bool, dtype=torch.bfloat16):
    """Fast profile: levels (B, H, W, C) of ``dtype`` (float32 noise,
    rounded to bf16 unless float32 is asked for) and boxes (B, R, 4) f32
    on the generator's device; the edge batch puts designed boxes first in
    every image."""
    dev = g.device
    feats = tuple(torch.randn((B, TILE // st, TILE // st, C), generator=g,
                              device=dev).to(dtype)
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


def _parity_pool_inputs(g, R: int, edge: bool, dtype=torch.bfloat16):
    """Parity profile: P2..P5 of an 800 px image, of ``dtype`` (as
    ``_pool_inputs``), and boxes with log-uniform sides from 2 to 800 px
    (long thin roads included); the edge batch puts designed boxes first
    in every image."""
    dev = g.device
    feats = tuple(torch.randn((PB, s, s, C), generator=g,
                              device=dev).to(dtype)
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
    boxes and levels read, the output written (float32 for float32
    levels, else bf16); box bytes are the
    cells each box touches, summed over the boxes (what a design that
    reads every box's region apart moves, from L2 where boxes overlap).
    FLOPs: the poolers' separable form, for each output bin (p, q) and
    channel, 2 per cell of row p's non-zero y-weights times column q's
    non-zero x-weights, and 2 per non-zero y-weight; int8 levels add 1 per touched cell and channel (its
    dequantization)."""
    from roadsurf_tpu_torch.ops.roi_align_kernel import axis_weights

    item = feats[0].element_size()
    nbytes = boxes.numel() * 4 + lvl.numel() * 4 \
        + boxes.shape[0] * boxes.shape[1] * P * P * C * (4 if item == 4
                                                         else 2)
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
               mode: str, **meta) -> dict:
    """One pooler call against its plain version, on ``feats`` (mode
    "bf16"), on int8 levels quantized from them ("int8") or on float32
    ``feats`` ("f32"). In float32 the plain version on the levels rounded
    to bf16 must fall outside the tolerance: the check separates the kernel
    from one that rounds its float32 levels inside."""
    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        reachable_levels

    n_lev = reachable_levels(feats)
    lvl = level_assignment(boxes, 224, 4, 2, 2 + n_lev - 1).contiguous()
    scales = None
    if mode == "int8":
        feats, scales = _quantized(feats)
    _require(mode != "f32" or all(f.dtype == torch.float32 for f in feats),
             f"{mode}: levels of {[f.dtype for f in feats]}")
    got = kernel(feats, boxes, lvl, P, s, feat_scales=scales)
    ref = plain(feats, boxes, lvl, P, s, feat_scales=scales)
    torch.cuda.synchronize()
    _require(got.dtype == (torch.float32 if mode == "f32"
                           else torch.bfloat16), f"{mode}: {got.dtype} out")
    case = {**meta, "mode": mode, "R": boxes.shape[1],
            "P": P, "sampling": s, "C": C, "B": boxes.shape[0],
            "levels": [f.shape[1] for f in feats],
            "boxes_per_level": torch.bincount(
                lvl.flatten(), minlength=n_lev).tolist(),
            **_agreement(got, ref)}
    if mode == "f32":
        rounded = plain(tuple(f.to(torch.bfloat16).float() for f in feats),
                        boxes, lvl, P, s)
        case["bf16_levels_out_of_tolerance"] = \
            _agreement(rounded, ref)["out_of_tolerance"]
        del rounded
        _require(case["bf16_levels_out_of_tolerance"] > 0,
                 f"{mode}: the tolerance does not separate the plain version"
                 f" on bf16-rounded levels: {case}")
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


def phase_kernels_k1(mode: str = "bf16") -> list:
    from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused, \
        roi_align_fused_ref

    name = "roi_align" if mode == "bf16" else f"roi_align_{mode}"
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for edge, poolers in ((False, POOLERS), (True, POOLERS + SPLIT)):
        for pooler, R, P in poolers:
            feats, boxes = _pool_inputs(
                g, R, edge,
                torch.float32 if mode == "f32" else torch.bfloat16)
            case = _pool_case(roi_align_fused, roi_align_fused_ref, feats,
                              boxes, P, 2, 5, mode, pooler=pooler,
                              edge=edge, main=not edge)
            _require(case["levels"] == [64, 32, 16]
                     and len(case["boxes_per_level"]) == 3,
                     f"not 3 levels of a 256 px tile: {case}")
            _emit({"phase": "kernels", "kernel": name, **case})
            _require(case["finite"] and case["out_of_tolerance"] == 0,
                     f"{name} disagrees with its plain version: {case}")
            cases.append(case)
    return cases


# K1 on four int8 levels of a 256 px tile (P5's 8x8xC block, which the
# reference's scripts/check_int8_pyramid_pooler_tpu.py checks on its TPU),
# the edge batch with its last four boxes on P5 (beyond the tile) and on
# P2: (name, R, P)
P5_POOLERS = (("box", 32, 7), ("mask", 32, 14))
P5_BOXES = ((-200, -200, 456, 456), (-100, -300, 356, 556), (0, 0, 256, 256),
            (1, 1, 9, 9))


def phase_kernels_k1_p5() -> list:
    """K1's int8 mode on P2..P5 (one scale a level), every P5 box pooled
    from the 8x8 level, against its plain version."""
    from roadsurf_tpu_torch.ops.roi_align import level_assignment
    from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused, \
        roi_align_fused_ref

    g = torch.Generator(device="cuda").manual_seed(4)
    cases = []
    for pooler, R, P in P5_POOLERS:
        feats, boxes = _pool_inputs(g, R, True)
        feats = feats + (torch.randn((B, TILE // 32, TILE // 32, C),
                                     generator=g, device="cuda")
                         .to(torch.bfloat16),)
        boxes[:, -len(P5_BOXES):] = torch.tensor(P5_BOXES, device="cuda",
                                                 dtype=torch.float32)
        lvl = level_assignment(boxes, 224, 4, 2, 5).contiguous()
        q, scales = _quantized(feats)
        got = roi_align_fused(q, boxes, lvl, P, 2, feat_scales=scales)
        ref = roi_align_fused_ref(q, boxes, lvl, P, 2, feat_scales=scales)
        case = {"pooler": f"{pooler}_p5", "mode": "int8", "R": R, "P": P,
                "levels": [f.shape[1] for f in feats],
                "boxes_per_level": torch.bincount(
                    lvl.flatten(), minlength=4).tolist(),
                **_agreement(got, ref)}
        _emit({"phase": "kernels", "kernel": "roi_align_int8", **case})
        _require(case["finite"] and case["out_of_tolerance"] == 0
                 and case["boxes_per_level"][3] > 0,
                 f"roi_align_int8 on P2..P5 disagrees or pooled no P5 box: "
                 f"{case}")
        cases.append(case)
    return cases


def phase_kernels_k2(mode: str = "bf16") -> list:
    from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
        roi_align_fused_blocked, roi_align_fused_blocked_ref

    name = "roi_align_blocked" if mode == "bf16" \
        else f"roi_align_blocked_{mode}"
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for edge, poolers in ((False, PPOOLERS), (True, PPOOLERS + PSPLIT)):
        for pooler, R, P, s in poolers:
            feats, boxes = _parity_pool_inputs(
                g, R, edge,
                torch.float32 if mode == "f32" else torch.bfloat16)
            case = _pool_case(roi_align_fused_blocked,
                              roi_align_fused_blocked_ref, feats, boxes, P,
                              s, 2, mode, pooler=pooler, edge=edge,
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


def _k5_inputs(g, Bn: int, side: int, levels, R: int, P: int, edge: bool,
               dtype=torch.bfloat16):
    """(level shapes, d pooled (Bn, R, P, P, C) of ``dtype`` (float32
    noise, rounded to bf16 unless float32 is asked for), boxes (Bn, R, 4)):
    boxes with log-uniform sides from 2 px to the image side; the edge
    batch puts first in every image boxes on every level, zero (padded GT)
    boxes and boxes on and across the borders."""
    dev = g.device
    shapes = [(Bn, s, s, C) for s in levels]
    dout = torch.randn((Bn, R, P, P, C), generator=g,
                       device=dev).to(dtype)
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
    each level's gradient written once (in d pooled's type: the timed calls
    write bf16 gradients from a bf16 d pooled, float32 from a float32 one);
    FLOPs of the separable form,
    per box and channel 2·P per non-zero x-weight (the x-contraction) and 2
    per non-zero y-weight and column of the box's region (the
    y-contraction)."""
    from roadsurf_tpu_torch.ops.roi_align_kernel import axis_weights

    grads = sum(int(np.prod(sh)) for sh in shapes)
    item = dout.element_size()
    nbytes = dout.numel() * item + boxes.numel() * 4 + lvl.numel() * 4 \
        + grads * item
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


def phase_kernels_k5(f32: bool = False) -> list:
    """K5 against its plain version, f32 gradients compared, at B=2 (and
    its bf16 gradients within one bf16 rounding), each launched twice and
    required bitwise equal; then K5 timed at the training batch, B=8,
    beside its plain time and its bound, with the histogram of kept boxes
    a tile. With ``f32``, a float32 d pooled (the float32 profiles'
    training; float32 noise, not rounded) and float32 gradients only, and
    the plain gradient of the d pooled rounded to bf16 must fall outside
    the tolerance: the check separates K5 from a kernel that rounds its
    float32 d pooled inside."""
    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        reachable_levels
    from roadsurf_tpu_torch.ops.roi_align_backward_kernel import \
        roi_align_backward, roi_align_backward_ref

    g = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for edge in (False, True):
        for name, side, levels, R, P, s, main in K5_CASES:
            dt = torch.float32 if f32 else torch.bfloat16
            shapes, dout, boxes = _k5_inputs(g, K5_CHECK_B, side, levels, R,
                                             P, edge, dt)
            metas = [torch.empty(sh, device="meta") for sh in shapes]
            n_lev = reachable_levels(metas)
            shapes = shapes[:n_lev]
            lvl = level_assignment(boxes, 224, 4, 2, 2 + n_lev - 1) \
                .contiguous()
            got = roi_align_backward(dout, shapes, boxes, lvl, P, s,
                                     dtype=torch.float32)
            again = roi_align_backward(dout, shapes, boxes, lvl, P, s,
                                       dtype=torch.float32)
            # the bf16 gradients (a float32 d pooled gives float32 only)
            got16 = [] if f32 else roi_align_backward(dout, shapes, boxes,
                                                      lvl, P, s)
            again16 = [] if f32 else roi_align_backward(dout, shapes, boxes,
                                                        lvl, P, s)
            ref = roi_align_backward_ref(dout, shapes, boxes, lvl, P, s)
            torch.cuda.synchronize()
            err, err16, bad, bad16, top = 0.0, 0.0, 0, 0, 0.0
            for k, k16, r in zip(got, got16 or got, ref):
                tol = K5_REL * float(r.abs().max()) + K5_ABS
                e = (k - r).abs()
                e16 = (k16.float() - r).abs()
                err, err16 = max(err, float(e.max())), max(err16,
                                                           float(e16.max()))
                top = max(top, float(r.abs().max()))
                bad += int((e > tol).sum())
                bad16 += int((e16 > REL_TOL * r.abs() + tol).sum())
            if f32:
                rounded = roi_align_backward_ref(
                    dout.to(torch.bfloat16).float(), shapes, boxes, lvl, P, s)
                sep = sum(int(((q - r).abs() > K5_REL * float(r.abs().max())
                               + K5_ABS).sum())
                          for q, r in zip(rounded, ref))
                del rounded
            case = {"pooler": name, "edge": edge, "main": main and not edge,
                    "dout": "f32" if f32 else "bf16",
                    "B_checked": K5_CHECK_B, "R": R, "P": P, "sampling": s,
                    "C": C, "levels": [sh[1] for sh in shapes],
                    "boxes_per_level": torch.bincount(
                        lvl.flatten(), minlength=n_lev).tolist(),
                    "max_abs_err": err, "max_abs_ref": top,
                    "out_of_tolerance": bad,
                    # a float32 d pooled has float32 gradients only
                    **({"bf16_dout_out_of_tolerance": sep} if f32 else
                       {"max_abs_err_bf16": err16,
                        "out_of_tolerance_bf16": bad16}),
                    "finite": all(bool(torch.isfinite(k).all())
                                  for k in got),
                    "bitwise_repeatable": all(
                        torch.equal(a, b) for a, b in zip(got + got16,
                                                          again + again16))}
            del got, got16, again, again16, ref
            if not edge:
                # timed at the training batch
                shapes8, dout8, boxes8 = _k5_inputs(g, TB, side, levels, R,
                                                    P, False, dt)
                out8 = dt
                shapes8 = shapes8[:n_lev]
                lvl8 = level_assignment(boxes8, 224, 4, 2,
                                        2 + n_lev - 1).contiguous()
                nbytes, flops = _k5_work(dout8, shapes8, boxes8, lvl8, P, s)
                case.update(
                    B=TB,
                    ms=_time_ms(lambda: roi_align_backward(
                        dout8, shapes8, boxes8, lvl8, P, s, dtype=out8), 10),
                    plain_ms=_time_ms(lambda: roi_align_backward_ref(
                        dout8, shapes8, boxes8, lvl8, P, s), 1, warmup=1),
                    library_ms=None,
                    boxes_a_tile=_k5_tiles(shapes8, boxes8, lvl8, P),
                    **_bound(nbytes, flops))
                del dout8
            torch.cuda.empty_cache()
            _emit({"phase": "kernels", "kernel": "roi_align_backward"
                   + ("_f32" if f32 else ""), **case})
            _require(case["finite"] and case["out_of_tolerance"] == 0
                     and case.get("out_of_tolerance_bf16", 0) == 0
                     and case["bitwise_repeatable"]
                     and case.get("bf16_dout_out_of_tolerance", 1) > 0,
                     f"roi_align_backward disagrees with its plain version"
                     f" or with itself, or its tolerance does not separate a"
                     f" bf16-rounded d pooled: {case}")
            cases.append(case)
    if not f32:
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
# K6: the conv epilogue

# the epilogue's launches in a bf16 inference forward (the stem; conv1,
# conv2 and the tail of 16 bottlenecks; the FPN's 4 laterals and 4 output
# convs; the RPN head's 3 convs on 5 levels; the mask head's 4 convs and
# its deconv); the int8 stack's forward has none
EPILOGUE = 1 + 16 * 3 + 4 + 4 + 3 * 5 + 4 + 1
# the epilogue's edge cases (untimed, NaN, ±0, ±inf and a subnormal among
# the values): C off the 8-channel vector, odd sides
K6_EDGES = (("bias", (2, 3, 13, 11)), ("bias_relu", (3, 64, 7, 9)),
            ("tail_shortcut", (2, 12, 5, 3)),
            ("tail_identity", (2, 20, 3, 5)), ("lateral", (2, 12, 4, 2)))
K6_SPECIAL = (float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1e-40)


def _plain_convs() -> int:
    """The forward's convs that took the plain ops so far
    (``ops.bias_act.counts``): none in a bf16 inference forward on the
    card."""
    from roadsurf_tpu_torch.ops.bias_act import counts

    return counts["plain"]


def _bf16_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def _k6_state(cfg, seed: int) -> dict:
    """Random weights (``_random_tree``) with every conv's bias drawn
    (the reference's are zero)."""
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    gen = torch.Generator().manual_seed(seed)
    state = from_jax_params(_random_tree(cfg, gen))

    def biases(node):
        if isinstance(node, dict):
            if "w" in node and "b" in node and node["w"].dim() == 4:
                node["b"] = 0.1 * torch.randn(node["b"].shape, generator=gen)
            for v in node.values():
                biases(v)
        elif isinstance(node, list):
            for v in node:
                biases(v)

    biases(state)
    return state


def _k6_case(kernel, plain, y, bias, kw) -> tuple:
    """One epilogue call in place on ``y`` against its plain version on
    the same inputs, the bf16 bits compared -> (the case, the output)."""
    want = plain(y, bias, **kw)
    got = kernel(y, bias, **kw)
    torch.cuda.synchronize()
    bad = int((_bf16_bits(got) != _bf16_bits(want)).sum())
    if kw.get("coarser") is not None:
        mode = "coarser"
    elif kw.get("residual") is None:
        mode = "bias"
    else:
        mode = "residual" if kw.get("residual_bias") is None \
            else "residual_bias"
    return {"shape": list(y.shape), "mode": mode,
            "relu": bool(kw.get("relu")), "mismatches": bad,
            "max_abs_err": bad}, got


def _k6_time(kernel, plain, shape, mode: str, relu: bool, g) -> dict:
    """The kernel's time on fresh bf16 maps of one call's shape (in
    place: the values change from call to call, the bytes do not), the
    plain version's, and the byte bound: ``y`` read and written, the
    residual or the coarser level read."""
    N, Cn, H, W = shape
    cl = torch.channels_last

    def draw(*s):
        return torch.randn(s, generator=g, device="cuda") \
            .to(torch.bfloat16).contiguous(memory_format=cl)

    y = draw(N, Cn, H, W)
    bias = torch.randn(Cn, generator=g, device="cuda").to(torch.bfloat16)
    kw, extra, flops = {"relu": relu}, 0, (2 if relu else 1)
    if mode == "coarser":
        kw["coarser"] = draw(N, Cn, H // 2, W // 2)
        extra, flops = kw["coarser"].numel(), flops + 1
    elif mode != "bias":
        kw["residual"] = draw(N, Cn, H, W)
        extra, flops = y.numel(), flops + 1
        if mode == "residual_bias":
            kw["residual_bias"] = torch.randn(
                Cn, generator=g, device="cuda").to(torch.bfloat16)
            flops += 1
    nbytes = 2 * (2 * y.numel() + extra + Cn)
    out = {"ms": _time_ms(lambda: kernel(y, bias, **kw), 10),
           "plain_ms": _time_ms(lambda: plain(y, bias, **kw), 3, warmup=1),
           "library_ms": None, **_bound(nbytes, flops * y.numel())}
    del y, kw
    return out


def phase_kernels_k6() -> list:
    """K6 (``bias_act``) at the main paths' shapes: every call of one bf16
    inference forward of the parity profile (B=16, 800 px) and of the fast
    profile (B=64, 256 px) on random weights with drawn biases, each held
    equal bit for bit to its plain version on the same inputs, the
    forward's launches EPILOGUE and no conv through the plain ops; then
    ``K6_EDGES``. The parity forward's calls are the ``kernels`` line's:
    each timed (once a shape and mode) beside its plain version and its
    byte bound."""
    from roadsurf_tpu_torch.models import fast_profile, forward_inference
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.ops import bias_act as epilogue

    kernel, plain = epilogue.bias_act, epilogue.bias_act_ref
    g = torch.Generator(device="cuda").manual_seed(6)
    parity = from_detectron2_yaml(os.path.join(ROOT, YAML))
    profiles = (("parity", parity, PB, "bits", True),
                ("fast", fast_profile(post_nms_topk=32), B, "logits",
                 False))
    cases, timed = [], {}
    for name, cfg, batch, mask_format, main in profiles:
        calls = []

        def recording(y, bias, relu=False, residual=None,
                      residual_bias=None, coarser=None):
            case, out = _k6_case(kernel, plain, y, bias, {
                "relu": relu, "residual": residual,
                "residual_bias": residual_bias, "coarser": coarser})
            calls.append(case)
            return out

        state = _k6_state(cfg, 6)
        tiles = np.random.default_rng(6).integers(
            0, 256, (batch, TILE, TILE, 3), np.uint8)
        before = epilogue.launches
        fused, plain0 = epilogue.counts["fused"], _plain_convs()
        epilogue.bias_act = recording
        try:
            forward_inference(state, tiles, cfg, mask_format=mask_format)
        finally:
            epilogue.bias_act = kernel
        torch.cuda.synchronize()
        launched = epilogue.launches - before
        # the convs: EPILOGUE and the 4 shortcut convs, each in its
        # block's tail
        _require(len(calls) == launched == EPILOGUE
                 and _plain_convs() == plain0
                 and epilogue.counts["fused"] - fused == EPILOGUE + 4,
                 f"bias_act {name}: {len(calls)} calls, {launched} "
                 f"launches, {_plain_convs() - plain0} plain convs; "
                 f"expected {EPILOGUE} and none")
        for i, c in enumerate(calls):
            key = (tuple(c["shape"]), c["mode"], c["relu"])
            if main and key not in timed:
                timed[key] = _k6_time(kernel, plain, *key, g)
            case = {"case": f"{name} {i:02d} {c['mode']}"
                    f"{'+relu' if c['relu'] else ''} "
                    f"{'x'.join(map(str, c['shape']))}", "main": main,
                    **c, **(timed[key] if main else {})}
            _emit({"phase": "kernels", "kernel": "bias_act", **case})
            _require(c["mismatches"] == 0,
                     f"bias_act differs from its plain version: {case}")
            cases.append(case)
        del state
        torch.cuda.empty_cache()
    for kind, shape in K6_EDGES:
        N, Cn, H, W = shape

        def special(*s):
            t = torch.randn(s, generator=g, device="cuda")
            flat = t.view(-1)
            idx = torch.randint(0, flat.numel(), (2 * len(K6_SPECIAL),),
                                generator=g, device="cuda")
            flat[idx] = torch.tensor(K6_SPECIAL, device="cuda").repeat(2)
            t = t.to(torch.bfloat16)
            return t.contiguous(memory_format=torch.channels_last) \
                if t.dim() == 4 else t

        kw = {"relu": kind != "bias" and kind != "lateral"}
        if kind.startswith("tail"):
            kw["residual"] = special(*shape)
            if kind == "tail_shortcut":
                kw["residual_bias"] = special(Cn)
        elif kind == "lateral":
            kw["coarser"] = special(N, Cn, H // 2, W // 2)
        case = {"case": f"edge {kind} {'x'.join(map(str, shape))}",
                "main": False,
                **_k6_case(kernel, plain, special(*shape), special(Cn),
                           kw)[0]}
        _emit({"phase": "kernels", "kernel": "bias_act", **case})
        _require(case["mismatches"] == 0,
                 f"bias_act differs from its plain version: {case}")
        cases.append(case)
    return cases


# ViTDet-B's attention calls in a bf16 forward: 8 windowed blocks and 4
# global ones; (kind, (B, Hp, Wp, window, heads)) of each at B=16 and
# 1024 px (the 64x64 grid padded to 70 for windows of 14); the kernel's
# launches of a forward by its path (``attention.path_launches``)
K7_LAUNCHES = 12
K7_PATHS = {"row": 4, "window": 8}
K7_SHAPES = (("window", (PB, 70, 70, 14, 12)),
             ("global", (PB, 64, 64, 64, 12)))


def _k7_tolerance(qkv, rel_h, rel_w, ws: int, scale: float, want):
    """2⁻⁷·(|plain| + Σⱼ pᵢⱼ|vⱼ|), element by element: both round their
    float32 result to bf16 (2⁻⁸ relative each, 2⁻⁷·|plain| together), and
    the kernel rounds each probability to bf16 (2⁻⁸ relative) before its
    product with v, which moves an output by at most 2⁻⁸ of its row's
    Σ p|v|, taken here as the plain version on |v| (itself rounded to
    bf16, hence 2⁻⁷); the float32 sums' order is far below both."""
    from roadsurf_tpu_torch.ops.attention import rel_attention_ref

    av = qkv.clone()
    av[:, :, :, 2].abs_()
    spv = rel_attention_ref(av, rel_h, rel_w, ws, scale).float()
    return 2.0 ** -7 * (want.float().abs() + spv)


def _k7_case(kernel, plain, qkv, rel_h, rel_w, ws: int, scale: float
             ) -> tuple:
    """One attention call against its plain version on the same inputs
    -> (the case, the kernel's output)."""
    want = plain(qkv, rel_h, rel_w, ws, scale)
    got = kernel(qkv, rel_h, rel_w, ws, scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = _k7_tolerance(qkv, rel_h, rel_w, ws, scale, want)
    B, Hp, Wp, _, heads, _ = qkv.shape
    return {"shape": [B, Hp, Wp, heads], "window": ws,
            "kind": "global" if ws == Hp == Wp else "window",
            "mismatches": int((err > tol).sum())
            + int((~torch.isfinite(got.float())).sum()),
            "max_abs_err": err.max().item(),
            "err_over_tol": (err / tol).max().item()}, got


def _k7_inputs(shape, g, rel_std: float):
    """qkv (B, Hp, Wp, 3, heads, 64) of unit normals and the tables of a
    drawn relative-position pair of std ``rel_std``, bf16."""
    from roadsurf_tpu_torch.ops.attention import rel_tables

    B, Hp, Wp, ws, heads = shape
    qkv = torch.randn((B, Hp, Wp, 3, heads, 64), generator=g,
                      device="cuda").to(torch.bfloat16)
    rp = (torch.randn((2, 2 * ws - 1, 64), generator=g, device="cuda")
          * rel_std).to(torch.bfloat16)
    return (qkv, *rel_tables(qkv[:, :, :, 0], rp[0], rp[1], ws))


def _k7_time(kernel, plain, shape, g) -> dict:
    """One call's time at ``shape`` on fresh inputs, the plain version's,
    and its bound: 4·N²·64 FLOPs a head and window at the bf16 peak, or
    q, k, v, the output and the two tables once at the memory's rate."""
    B, Hp, Wp, ws, heads = shape
    qkv, rel_h, rel_w = _k7_inputs(shape, g, 0.1)
    N, windows = ws * ws, B * (Hp // ws) * (Wp // ws)
    flops = windows * heads * 4 * N * N * 64
    nbytes = windows * heads * (4 * N * 64 + 2 * N * ws) * 2
    out = {"ms": _time_ms(lambda: kernel(qkv, rel_h, rel_w, ws, 0.125), 10),
           "plain_ms": _time_ms(lambda: plain(qkv, rel_h, rel_w, ws, 0.125),
                                2, warmup=1),
           "library_ms": None, **_bound(nbytes, flops, BF16_FLOPS_PER_S)}
    del qkv, rel_h, rel_w
    return out


def phase_kernels_k7() -> tuple:
    """K7 (``rel_attention``) at ViTDet-B's shapes: every call of one bf16
    forward at B=16 (``vitdet_b()``, 1024 px from 256 px tiles, the
    benchmark family's weights of seed 7, whose relative-position tables,
    position embedding and qkv bias are drawn away from zero) held within
    :func:`_k7_tolerance` of its plain version, ``K7_LAUNCHES`` launches
    and no call through the plain version; each call timed by its kind
    (:func:`_k7_time`), so the ``kernels`` line's K7 is one forward's
    calls, and the global calls on the kernel's row path and the windowed
    ones on its window path (``K7_PATHS``); then ``K7_SHAPES`` on unit
    normals with tables of std 1.
    -> (the cases, {"launches": the forward's launch counts})."""
    from portbench import modelgen, spec
    from roadsurf_tpu_torch.models.config import vitdet_b
    from roadsurf_tpu_torch.models.mask_rcnn import forward_prepared, \
        prepare_state
    from roadsurf_tpu_torch.ops import attention as att

    kernel, plain = att.rel_attention, att.rel_attention_ref
    g = torch.Generator(device="cuda").manual_seed(7)
    cfg = vitdet_b()
    cell = spec.cell("vitdet-b-1024.detect-b16")
    state = prepare_state(cell.family.weights(
        cell.config["settings"], modelgen.generator(7, "cuda"), "cuda",
        torch.bfloat16), cfg, "cuda")
    tiles = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (PB, TILE, TILE, 3), np.uint8)).cuda()
    calls = []

    def recording(qkv, rel_h, rel_w, ws, scale):
        case, out = _k7_case(kernel, plain, qkv, rel_h, rel_w, ws, scale)
        calls.append(case)
        return out

    fused, plain0 = att.counts["fused"], att.counts["plain"]
    _reset_counts()
    att.rel_attention = recording
    try:
        with torch.inference_mode():
            forward_prepared(state, tiles, cfg, True, "bits")
    finally:
        att.rel_attention = kernel
    torch.cuda.synchronize()
    launches = _read_counts()
    paths = dict(att.path_launches)
    kinds = [c["kind"] for c in calls]
    _require(len(calls) == launches["rel_attention"] == K7_LAUNCHES
             and att.counts["fused"] - fused == K7_LAUNCHES
             and att.counts["plain"] == plain0
             and kinds.count("global") == 4 and paths == K7_PATHS,
             f"rel_attention: {len(calls)} calls ({kinds}), "
             f"{launches['rel_attention']} launches ({paths} by path), "
             f"{att.counts['plain'] - plain0} plain; expected "
             f"{K7_LAUNCHES}, 4 of them global, {K7_PATHS} by path, and "
             f"none plain")
    _emit({"phase": "kernels", "kernel": "rel_attention",
           "path_launches": paths})
    del state, tiles
    torch.cuda.empty_cache()
    timed = {kind: _k7_time(kernel, plain, shape, g)
             for kind, shape in K7_SHAPES}
    cases = []
    for i, c in enumerate(calls):
        cases.append({"case": f"vitdet {i:02d} {c['kind']}", "main": True,
                      **c, **timed[c["kind"]]})
    for kind, shape in K7_SHAPES:
        c, _ = _k7_case(kernel, plain, *_k7_inputs(shape, g, 1.0), shape[3],
                        0.125)
        cases.append({"case": f"rel_std1 {kind}", "main": False, **c})
    for case in cases:
        _emit({"phase": "kernels", "kernel": "rel_attention", **case})
        _require(case["mismatches"] == 0,
                 f"rel_attention outside its tolerance: {case}")
    torch.cuda.empty_cache()
    return cases, {"launches": launches}


# ---------------------------------------------------------------------------
# K8: ViTDet's LayerNorms

# a bf16 ViTDet-B forward's LN calls: 24 in the blocks (block 0's norm1
# alone, the 11 others' with the previous MLP's output summed in, every
# norm2 with the attention's; the windowed blocks' norm1 stored into the
# 70x70 padded grid, their norm2's residual a slice of it), 9 in the
# pyramid (P2's with its GELU), and the box head's and the mask head's 4
# convs' each with its ReLU
K8_LAUNCHES = 41
# a call at the ViT's 4096 x 768 rows takes at most 1 / K8_FLOOR of its
# byte bound
K8_FLOOR = 0.70
# the forward's calls by shape and mode, (B, H, W, C), residual ("none",
# "dense" or a "strided" slice of the padded grid), act, pad_to: block 0's
# norm1, a windowed block's norm1 and norm2, a global block's two; P2's
# LN with GELU; the pyramid's LNs at P2..P5; the box and mask heads'
K8_SHAPES = (((PB, 64, 64, 768), "none", None, (70, 70)),
             ((PB, 64, 64, 768), "dense", None, (70, 70)),
             ((PB, 64, 64, 768), "strided", None, None),
             ((PB, 64, 64, 768), "dense", None, None),
             ((PB, 128, 128, 384), "none", "gelu", None),
             ((PB, 256, 256, 256), "none", None, None),
             ((PB, 128, 128, 256), "none", None, None),
             ((PB, 64, 64, 256), "none", None, None),
             ((PB, 32, 32, 256), "none", None, None),
             ((PB * 1000, 7, 7, 256), "none", "relu", None),
             ((PB * 100, 14, 14, 256), "none", "relu", None))
# ReLU's slope is at most 1, exact GELU's 1.13 (at x = √2)
K8_SLOPE = {None: 1.0, "relu": 1.0, "gelu": 1.13}
# (name, (B, H, W, C), residual: "none", "dense" or "strided", act, pad_to,
# constant rows): rows that leave the last block ragged (15 rows, 7 x 11),
# ragged pads, at each of the three widths; rows of one value (variance 0);
# the 70x70 padded store with a strided residual
K8_EDGES = (("ragged", (1, 3, 5, 768), "dense", None, None, False),
            ("ragged_relu", (3, 7, 11, 256), "strided", "relu", None, False),
            ("ragged_pad_gelu", (2, 5, 9, 384), "dense", "gelu", (7, 14),
             False),
            ("constant", (2, 8, 8, 768), "none", None, (9, 9), True),
            ("constant_sum", (2, 8, 8, 256), "dense", "relu", None, True),
            ("pad70_strided", (PB, 64, 64, 768), "strided", None, (70, 70),
             False))


def _k8_inputs(shape, residual: str, g, constant: bool = False):
    """x (B, H, W, C) about N(0.5, 2), w about 1, b about 0, and the
    residual: none, contiguous, or a slice of a larger grid (a padded
    grid's rows); bf16. ``constant``: every third row of x one value, the
    residual's zero there."""
    B, H, W, C = shape
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5
         ).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(C, generator=g, device="cuda")
         ).to(torch.bfloat16)
    b = (0.1 * torch.randn(C, generator=g, device="cuda")).to(torch.bfloat16)
    r = None
    if residual == "dense":
        r = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    elif residual == "strided":
        r = torch.randn((B, H + 6, W + 7, C), generator=g, device="cuda"
                        ).to(torch.bfloat16)[:, :H, :W]
    if constant:
        x.view(-1, C)[::3] = 0.75
        if r is not None:
            r = r.contiguous()
            r.view(-1, C)[::3] = 0
    return x, w, b, r


def _k8_case(x, w, b, eps, residual, act, pad_to, s, y) -> dict:
    """One LN call of the kernel against its plain version on the same
    inputs: ``s`` bit for bit PyTorch's bf16 add, ``y`` within
    2⁻⁸·|plain| + 1e-4 of the plain version in float32 on that sum (its
    LN before the activation, carried through the activation's slope;
    GELU's output rounded once more to bf16, 2⁻⁸ of it), the pad's bits
    exactly zero."""
    from roadsurf_tpu_torch.ops.layer_norm import layer_norm_ref

    want_s = x if residual is None else x + residual
    args = (want_s.float(), w.float(), b.float(), eps)
    _, z = layer_norm_ref(*args, pad_to=pad_to)
    _, want = layer_norm_ref(*args, act=act, pad_to=pad_to)
    tol = K8_SLOPE[act] * (2.0 ** -8 * z.abs() + 1e-4)
    if act == "gelu":
        tol += 2.0 ** -8 * want.abs()
    err = (y.float() - want).abs()
    B, H, W, C = x.shape
    bits = y.view(torch.int16)
    return {"shape": [B, H, W, C],
            "residual": "none" if residual is None else
            "dense" if residual.is_contiguous() else "strided",
            "act": act, "pad_to": None if pad_to is None else list(pad_to),
            "mismatches": int((err > tol).sum())
            + int((~torch.isfinite(y.float())).sum()),
            "s_mismatches": 0 if residual is None else int(
                (s.view(torch.int16) != want_s.view(torch.int16)).sum()),
            "pad_nonzero": int(bits[:, H:].count_nonzero())
            + int(bits[:, :H, W:].count_nonzero()),
            "max_abs_err": err.max().item(),
            "err_over_tol": (err / tol).max().item()}


def _k8_bytes(shape, residual: bool, pad_to) -> int:
    """A call's bytes, each input read once and each output written once:
    x, w and b, and with a residual r and s; y at the padded grid."""
    B, H, W, C = shape
    Hp, Wp = pad_to or (H, W)
    rows = B * H * W * C * 2
    return rows * (3 if residual else 1) + B * Hp * Wp * C * 2 + 4 * C


def _k8_time(kernel, plain, key, g) -> dict:
    """One call's time at ``key`` (shape, residual, act, pad_to) on fresh
    inputs, the plain version's, and its byte bound."""
    shape, residual, act, pad_to = key
    x, w, b, r = _k8_inputs(shape, residual, g)
    # a call at the ViT's smallest rows takes ~80 µs: enough warm-up calls
    # to bring the card's clock up from the forward's synchronised calls
    out = {"ms": _time_ms(lambda: kernel(x, w, b, 1e-6, r, act, pad_to),
                          50, warmup=20),
           "plain_ms": _time_ms(lambda: plain(x, w, b, 1e-6, r, act,
                                              pad_to), 3, warmup=1),
           "library_ms": None,
           **_bound(_k8_bytes(shape, r is not None, pad_to), 0.0)}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    del x, w, b, r
    return out


def phase_kernels_k8() -> list:
    """K8 (``layer_norm``) at ViTDet-B's shapes: every LN call of one bf16
    forward at B=16 (``vitdet_b()``, 1024 px from 256 px tiles, the
    benchmark family's weights of seed 8) held to its plain version
    (:func:`_k8_case`), ``K8_LAUNCHES`` launches and no call through the
    plain version; one call of each shape and mode timed beside its plain
    version and its byte bound (:func:`_k8_time`), so the ``kernels``
    line's K8 is one forward's calls; each call at the ViT's 4096 × 768
    rows must reach ``K8_FLOOR`` of its bound. Then ``K8_EDGES``."""
    from portbench import modelgen, spec
    from roadsurf_tpu_torch.models.config import vitdet_b
    from roadsurf_tpu_torch.models.mask_rcnn import forward_prepared, \
        prepare_state
    from roadsurf_tpu_torch.ops import layer_norm as lnm

    kernel, plain = lnm.layer_norm_rows, lnm.layer_norm_ref
    g = torch.Generator(device="cuda").manual_seed(8)
    cfg = vitdet_b()
    cell = spec.cell("vitdet-b-1024.detect-b16")
    state = prepare_state(cell.family.weights(
        cell.config["settings"], modelgen.generator(8, "cuda"), "cuda",
        torch.bfloat16), cfg, "cuda")
    tiles = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (PB, TILE, TILE, 3), np.uint8)).cuda()
    calls = []

    def recording(x, w, b, eps, residual=None, act=None, pad_to=None):
        s, y = kernel(x, w, b, eps, residual, act, pad_to)
        torch.cuda.synchronize()
        calls.append(_k8_case(x, w, b, eps, residual, act, pad_to, s, y))
        return s, y

    fused, plain0 = lnm.counts["fused"], lnm.counts["plain"]
    _reset_counts()
    lnm.layer_norm_rows = recording
    try:
        with torch.inference_mode():
            forward_prepared(state, tiles, cfg, True, "bits")
    finally:
        lnm.layer_norm_rows = kernel
    torch.cuda.synchronize()
    launches = _read_counts()["layer_norm"]
    keys = [(tuple(c["shape"]), c["residual"], c["act"],
             None if c["pad_to"] is None else tuple(c["pad_to"]))
            for c in calls]
    _require(len(calls) == launches == K8_LAUNCHES
             and lnm.counts["fused"] - fused == K8_LAUNCHES
             and lnm.counts["plain"] == plain0
             and set(keys) == set(K8_SHAPES),
             f"layer_norm: {len(calls)} calls ({sorted(set(keys), key=str)}), "
             f"{launches} launches, {lnm.counts['plain'] - plain0} plain; "
             f"expected {K8_LAUNCHES} calls of K8_SHAPES and none plain")
    del state, tiles
    torch.cuda.empty_cache()
    timed = {}
    cases = []
    for i, (c, key) in enumerate(zip(calls, keys)):
        if key not in timed:
            timed[key] = _k8_time(kernel, plain, key, g)
            torch.cuda.empty_cache()
        cases.append({"case": f"vitdet {i:02d} {c['residual']} "
                      f"{c['act'] or ''} {'x'.join(map(str, c['shape']))}"
                      f"{'' if key[3] is None else ' pad %dx%d' % key[3]}",
                      "main": True, **c, **timed[key]})
    for name, shape, residual, act, pad_to, constant in K8_EDGES:
        x, w, b, r = _k8_inputs(shape, residual, g, constant)
        s, y = kernel(x, w, b, 1e-6, r, act, pad_to)
        torch.cuda.synchronize()
        cases.append({"case": f"edge {name}", "main": False,
                      **_k8_case(x, w, b, 1e-6, r, act, pad_to, s, y)})
        del x, w, b, r, s, y
    for case in cases:
        _emit({"phase": "kernels", "kernel": "layer_norm", **case})
        _require(case["mismatches"] == case["s_mismatches"]
                 == case["pad_nonzero"] == 0,
                 f"layer_norm outside its tolerance: {case}")
        if case["main"] and case["shape"][1:] == [64, 64, 768]:
            _require(case["bound_share"] >= K8_FLOOR,
                     f"layer_norm at {K8_FLOOR:.0%} of its byte bound at "
                     f"the ViT's rows: {case}")
    torch.cuda.empty_cache()
    return cases


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
    count 0), that no conv took the plain ops where the epilogue kernel
    engages, the outputs and the engine against a direct forward of the
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
    plain0 = _plain_convs()
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
    _require(_plain_convs() == plain0, f"{label}: "
             f"{_plain_convs() - plain0} convs took the plain ops")
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
        {"roi_align_int8": 2} if int8
        else {"roi_align": 2, "bias_act": EPILOGUE}, "mask_logits", (28, 28))
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
        {"roi_align_blocked_int8": 2, "nms": 2} if int8
        else {"roi_align_blocked": 2, "nms": 2, "bias_act": EPILOGUE},
        "mask_bits", (98,))
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
        {"roi_align": 2, "nms": 2, "bias_act": EPILOGUE}, "mask_logits",
        (28, 28))
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
# the same step of the YAML's model in float32 (dp_train (a)): K2 and K5 in
# their float32 modes
STEP_LAUNCHES_F32 = {"roi_align_blocked_f32": 2, "roi_align_backward_f32": 2,
                     "nms": 1}


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


def _counting_steps(training, steps: list):
    """Wrap ``training.train_step`` so each step appends its size, its
    device ms (CUDA events) and its kernels' launches to ``steps``;
    returns the original to put back."""
    step_fn = training.train_step

    def timed_step(cfg_, size, group=None):
        fn = step_fn(cfg_, size, group)

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

    training.train_step = timed_step
    return step_fn


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
    eval_fn = training.evaluate_dataset

    def timed_eval(*args, **kw):
        t0 = time.perf_counter()
        out = eval_fn(*args, **kw)
        evals.append({"seconds": time.perf_counter() - t0, "ap": out})
        return out

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    step_fn = _counting_steps(training, steps)
    training.evaluate_dataset = timed_eval
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
           # the host clock's step time from metrics.jsonl (imgs_per_sec
           # a step, log_every 1), steps 2..6: what dp_train_run reports
           "host_s_per_step": _host_s_per_step(losses, TB),
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


# ---------------------------------------------------------------------------
# the tileset path: label preparation, tilesets, then training on them

# the synthetic swissTLM3D scene (EPSG:2056): a GRID x GRID jittered road
# grid SPACING m apart (+-JITTER m), its two-node segments the roads, in a
# 3 km x 3 km AOI at (SCENE_X0, SCENE_Y0)
SCENE_X0, SCENE_Y0, SCENE_SIDE = 2600000.0, 1200000.0, 3000.0
GRID, SPACING, JITTER = 20, 150.0, 30.0
# OBJEKTART of the width table: 2 and 9, and a few 20 and 21 (re-ranked to
# 8.5 and 2.5 in the de-overlap); 14 (a ferry) is no road
ROAD_WIDTHS = {2: 8.0, 9: 4.0, 20: 5.0, 21: 6.0}
TILESET_STEPS = 2


def scene_roads(n: int, seed: int, rare: float = 0.1):
    """The road lines of an ``n`` x ``n`` jittered grid: 2·n·(n - 1)
    two-node segments, OBJEKTART 2 or 9 (20 or 21 with probability
    ``rare``), BELAGSART 100 or 200 (~3% 999997, unknown), KUNSTBAUTE 100
    (~4% 200, an uncovered bridge; ~4% 300, covered, filtered out)."""
    import pandas as pd

    from roadsurf_tpu_torch.geom import GeoDataFrame, LineString

    rng = np.random.default_rng(seed)
    off = (SCENE_SIDE - (n - 1) * SPACING) / 2
    xs = SCENE_X0 + off + np.arange(n) * SPACING
    ys = SCENE_Y0 + off + np.arange(n) * SPACING
    nodes = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1) \
        + rng.uniform(-JITTER, JITTER, (n, n, 2))
    segs = [(nodes[i, j], nodes[i + 1, j]) for i in range(n - 1)
            for j in range(n)]
    segs += [(nodes[i, j], nodes[i, j + 1]) for i in range(n)
             for j in range(n - 1)]
    m = len(segs)
    cls = rng.choice([2, 9], m)
    rare_ = rng.random(m) < rare
    cls[rare_] = rng.choice([20, 21], int(rare_.sum()))
    surface = rng.choice([100, 200], m)
    surface[rng.random(m) < 0.03] = 999997
    kunst = np.full(m, 100)
    u = rng.random(m)
    kunst[u < 0.08] = 200
    kunst[u < 0.04] = 300
    return GeoDataFrame(pd.DataFrame({
        "OBJECTID": np.arange(1, m + 1), "OBJEKTART": cls,
        "KUNSTBAUTE": kunst, "BELAGSART": surface,
        "geometry": [LineString(np.stack(s)) for s in segs]}),
        crs="EPSG:2056")


def write_scene(root: str, n: int = GRID, seed: int = 0,
                rare: float = 0.1) -> str:
    """Label preparation's ``data/`` under ``root`` with the port's writers:
    the roads of :func:`scene_roads`, ten forest polygons, the AOI (also as
    the restricted training AOI) and ``roads_parameters.xlsx``; returns the
    data directory."""
    import pandas as pd

    from roadsurf_tpu_torch.geom import GeoDataFrame, Polygon
    from roadsurf_tpu_torch.io import write_file, write_xlsx

    rng = np.random.default_rng(seed + 1)
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "swissTLM3D"), exist_ok=True)
    os.makedirs(os.path.join(data, "AOI"), exist_ok=True)
    write_file(scene_roads(n, seed, rare),
               os.path.join(data, "swissTLM3D", "roads_lines.shp"))
    forests = []
    for k in range(10):
        c = SCENE_X0 + rng.uniform(300, SCENE_SIDE - 300, 2) \
            + np.array([0.0, SCENE_Y0 - SCENE_X0])
        a = np.sort(rng.uniform(0, 2 * np.pi, 7))
        r = rng.uniform(40, 160, 7)
        forests.append(Polygon(c + np.stack([r * np.cos(a),
                                             r * np.sin(a)], 1)))
    write_file(GeoDataFrame({"UUID": [f"forest-{k}" for k in range(10)],
                             "geometry": forests}, crs="EPSG:2056"),
               os.path.join(data, "swissTLM3D", "forests.shp"))
    aoi = GeoDataFrame({"geometry": [Polygon(
        [(SCENE_X0, SCENE_Y0), (SCENE_X0 + SCENE_SIDE, SCENE_Y0),
         (SCENE_X0 + SCENE_SIDE, SCENE_Y0 + SCENE_SIDE),
         (SCENE_X0, SCENE_Y0 + SCENE_SIDE)])]}, crs="EPSG:2056")
    write_file(aoi, os.path.join(data, "AOI", "aoi.shp"))
    write_file(aoi, os.path.join(data, "AOI", "2_tiles_AOI.shp"))
    codes = [*ROAD_WIDTHS, 14]
    write_xlsx(pd.DataFrame({
        "GDB-Code": codes,
        "Type": ["Strasse", "Weg", "Zufahrt", "Platz", "Faehre"],
        "to keep": ["yes"] * len(ROAD_WIDTHS) + ["no"],
        "Definition": ["road"] * len(ROAD_WIDTHS) + ["ferry"],
        "Width": [*ROAD_WIDTHS.values(), None]}),
        os.path.join(data, "roads_parameters.xlsx"))
    return data


def png_bytes(img: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as PNG, every row Up-filtered."""
    import zlib

    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, w * c), np.uint8))
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


class MosaicOpener:
    """Serves the z18 tiles of ``tiles_aoi.geojson`` as PNG bytes cut from
    one mosaic: noise, with the ground-truth polygons (EPSG:4326 GeoJSON)
    filled by the port's ``geom_rasterize`` in one colour a category."""

    COLOURS = {"artificial": (200, 200, 190), "natural": (150, 110, 60)}

    def __init__(self, tiles_geojson: str, labels_geojson: str, seed: int):
        from roadsurf_tpu_torch.geom import _native
        from roadsurf_tpu_torch.io import read_file
        from roadsurf_tpu_torch.tiles import Tile, WebMercatorQuad, \
            parse_tile_id

        ts = [parse_tile_id(t) for t in read_file(tiles_geojson)["id"]]
        self.x0, self.y0 = min(t.x for t in ts), min(t.y for t in ts)
        nx = max(t.x for t in ts) - self.x0 + 1
        ny = max(t.y for t in ts) - self.y0 + 1
        self.west, _, _, self.north = WebMercatorQuad.xy_bounds(
            Tile(self.x0, self.y0, 18))
        self.px = WebMercatorQuad.tile_span(18) / TILE
        rng = np.random.default_rng(seed)
        self.mosaic = rng.integers(60, 120, (ny * TILE, nx * TILE, 3),
                                   np.uint8)
        labels = read_file(labels_geojson).to_crs(epsg=3857)
        self.n_polygons = 0
        for g, cat in zip(labels.geometry.values, labels["CATEGORY"]):
            for p in (g.geoms if g.geom_type == "MultiPolygon" else [g]):
                x0, y0, x1, y1 = p.bounds
                c0 = max(int((x0 - self.west) / self.px), 0)
                r0 = max(int((self.north - y1) / self.px), 0)
                c1 = min(int((x1 - self.west) / self.px) + 1, nx * TILE)
                r1 = min(int((self.north - y0) / self.px) + 1, ny * TILE)
                if c1 <= c0 or r1 <= r0:
                    continue
                m = _native.rasterize(
                    _native.pack([[p.exterior_coords,
                                   *p.interiors_coords]]),
                    self.west + c0 * self.px, self.px,
                    self.north - r0 * self.px, -self.px, r1 - r0, c1 - c0)
                self.mosaic[r0:r1, c0:c1][m > 0] = self.COLOURS[cat]
                self.n_polygons += 1
        self.served = 0

    def tile(self, x: int, y: int) -> np.ndarray:
        r, c = (y - self.y0) * TILE, (x - self.x0) * TILE
        return self.mosaic[r:r + TILE, c:c + TILE]

    def __call__(self, url: str) -> bytes:
        z, x, y = url.rsplit("/", 3)[1:]
        self.served += 1
        return png_bytes(self.tile(int(x), int(y.split(".")[0])))


class BandsOpener:
    """Serves the z18 tiles of ``tiles_aoi.geojson`` as 4-band TIFF bytes
    (R, G, B, NIR: what the statistical YAML's tile service returns for
    ``bidx=2,3,4,1``), cut from one mosaic drawn as ``MosaicOpener`` draws
    its 3 bands: noise, with the road polygons (any frame with BELAGSART,
    e.g. ``roads_polygons_stats.shp``) filled by ``geom_rasterize`` in one
    colour a surface, each road's own shade of it, with noise."""

    COLOURS = {100: (190, 185, 175, 110), 200: (130, 105, 70, 165)}

    def __init__(self, tiles_geojson: str, roads, seed: int, tmp_dir: str):
        import re

        from roadsurf_tpu_torch.geom import _native
        from roadsurf_tpu_torch.io import read_file
        from roadsurf_tpu_torch.tiles import Tile, WebMercatorQuad, \
            parse_tile_id

        self._re = re.compile(r"/(\d+)/(\d+)/(\d+)\.tif")
        self._tmp = tmp_dir     # a tile is encoded through a file here
        ts = [parse_tile_id(t) for t in read_file(tiles_geojson)["id"]]
        self.x0, self.y0 = min(t.x for t in ts), min(t.y for t in ts)
        nx = max(t.x for t in ts) - self.x0 + 1
        ny = max(t.y for t in ts) - self.y0 + 1
        self.west, _, _, self.north = WebMercatorQuad.xy_bounds(
            Tile(self.x0, self.y0, 18))
        self.px = WebMercatorQuad.tile_span(18) / TILE
        rng = np.random.default_rng(seed)
        self.mosaic = rng.integers(40, 140, (ny * TILE, nx * TILE, 4),
                                   np.uint8)
        roads = roads.to_crs(epsg=3857)
        for g, surface in zip(roads.geometry.values, roads["BELAGSART"]):
            colour = self.COLOURS.get(int(surface))
            if g is None or g.is_empty or colour is None:
                continue
            shade = np.array(colour) + rng.integers(-15, 16, 4)
            for p in (g.geoms if g.geom_type == "MultiPolygon" else [g]):
                x0, y0, x1, y1 = p.bounds
                c0 = max(int((x0 - self.west) / self.px), 0)
                r0 = max(int((self.north - y1) / self.px), 0)
                c1 = min(int((x1 - self.west) / self.px) + 1, nx * TILE)
                r1 = min(int((self.north - y0) / self.px) + 1, ny * TILE)
                if c1 <= c0 or r1 <= r0:
                    continue
                m = _native.rasterize(
                    _native.pack([[p.exterior_coords,
                                   *p.interiors_coords]]),
                    self.west + c0 * self.px, self.px,
                    self.north - r0 * self.px, -self.px, r1 - r0, c1 - c0)
                inside = m > 0
                self.mosaic[r0:r1, c0:c1][inside] = np.clip(
                    shade + rng.integers(-12, 13, (int(inside.sum()), 4)),
                    0, 255)
        self.served = 0

    def tile(self, x: int, y: int) -> np.ndarray:
        r, c = (y - self.y0) * TILE, (x - self.x0) * TILE
        return self.mosaic[r:r + TILE, c:c + TILE]

    def __call__(self, url: str) -> bytes:
        import threading

        from roadsurf_tpu_torch.io import write_geotiff
        from roadsurf_tpu_torch.tiles import Tile, WebMercatorQuad

        z, x, y = map(int, self._re.search(url).groups())
        path = os.path.join(self._tmp,
                            f"{z}_{x}_{y}_{threading.get_ident()}.tif")
        write_geotiff(path, self.tile(x, y),
                      WebMercatorQuad.xy_bounds(Tile(x, y, z)))
        with open(path, "rb") as f:
            blob = f.read()
        os.remove(path)
        self.served += 1
        return blob


def fill_polygons(geoms, x0: float, y0: float, px: float, h: int,
                  w: int) -> np.ndarray:
    """The even-odd pixel-centre fill of each (Multi)Polygon, OR-ed, on the
    grid whose pixel (r, c) has its centre at (x0 + (c + .5)·px, y0 + (r +
    .5)·px)."""
    from roadsurf_tpu_torch.geom import _native

    out = np.zeros((h, w), bool)
    for g in geoms:
        if g is None or g.is_empty:
            continue
        for p in (g.geoms if g.geom_type == "MultiPolygon" else [g]):
            bx0, by0, bx1, by1 = p.bounds
            c0, c1 = max(int((bx0 - x0) / px) - 1, 0), \
                min(int((bx1 - x0) / px) + 2, w)
            r0, r1 = max(int((by0 - y0) / px) - 1, 0), \
                min(int((by1 - y0) / px) + 2, h)
            if c1 <= c0 or r1 <= r0:
                continue
            out[r0:r1, c0:c1] |= _native.rasterize(
                _native.pack([[p.exterior_coords, *p.interiors_coords]]),
                x0 + c0 * px, px, y0 + r0 * px, px, r1 - r0,
                c1 - c0).astype(bool)
    return out


def near_segments(segments, d: float, x0: float, y0: float, px: float,
                  h: int, w: int) -> np.ndarray:
    """Pixel centres within ``d`` of any of ``segments`` ((2, 2) arrays),
    by the point-segment distance (no geometry operation involved)."""
    out = np.zeros((h, w), bool)
    for a, b in segments:
        lo, hi = np.minimum(a, b) - d, np.maximum(a, b) + d
        c0, c1 = max(int((lo[0] - x0) / px), 0), min(int((hi[0] - x0) / px)
                                                     + 2, w)
        r0, r1 = max(int((lo[1] - y0) / px), 0), min(int((hi[1] - y0) / px)
                                                     + 2, h)
        if c1 <= c0 or r1 <= r0:
            continue
        xs = x0 + (np.arange(c0, c1) + 0.5) * px
        ys = y0 + (np.arange(r0, r1) + 0.5) * px
        qx, qy = np.meshgrid(xs - a[0], ys - a[1])
        ab = b - a
        t = np.clip((qx * ab[0] + qy * ab[1]) / max(ab @ ab, 1e-300), 0, 1)
        out[r0:r1, c0:c1] |= np.hypot(qx - t * ab[0], qy - t * ab[1]) <= d
    return out


def aoi_oracle(road_lines, forests, width: float, px: float = 1.0) -> dict:
    """The restricted AOI's raster oracle: pixel centres within ``width``
    of a road line, minus those inside a forest or within 3 m of one, at
    ``px`` m; and the fields, the parts of the rest the roads enclose
    (pixels joined by a side or a corner), counted where no 3 m-buffered
    forest reaches them."""
    from scipy import ndimage

    segs = [(c[i], c[i + 1]) for g in road_lines
            for c in [np.asarray(g.coords_array, np.float64)]
            for i in range(len(c) - 1)]
    xy = np.concatenate([np.stack(s) for s in segs])
    x0, y0 = xy.min(0) - width - 3 * px - 0.0137
    x1, y1 = xy.max(0) + width + 3 * px
    h, w = int(np.ceil((y1 - y0) / px)), int(np.ceil((x1 - x0) / px))
    roads = near_segments(segs, width, x0, y0, px, h, w)
    fsegs = [(r[i], r[(i + 1) % len(r)]) for f in forests
             for p in (f.geoms if f.geom_type == "MultiPolygon" else [f])
             for r in (p.exterior_coords, *p.interiors_coords)
             for i in range(len(r))]
    forest = fill_polygons(forests, x0, y0, px, h, w) \
        | near_segments(fsegs, 3.0, x0, y0, px, h, w)
    lab, n = ndimage.label(~roads, structure=np.ones((3, 3)))
    outside = lab[0, 0]
    touched = set(np.unique(lab[forest & ~roads]))
    free = [k for k in range(1, n + 1) if k != outside and k not in touched]
    return {"truth": roads & ~forest, "box": (x0, y0, px, h, w),
            "fields": n - 1, "fields_free": len(free)}


def aoi_agreement(raoi_geoms, oracle: dict) -> dict:
    """The restricted AOI (its polygons) against ``aoi_oracle``: m² where
    they differ, the oracle's m² and the AOI's holes."""
    x0, y0, px, h, w = oracle["box"]
    got = fill_polygons(raoi_geoms, x0, y0, px, h, w)
    holes = sum(len(p.interiors_coords) for g in raoi_geoms
                if g is not None and not g.is_empty
                for p in (g.geoms if g.geom_type == "MultiPolygon" else [g]))
    return {"mismatch_m2": float((got != oracle["truth"]).sum() * px * px),
            "oracle_m2": float(oracle["truth"].sum() * px * px),
            "holes": holes, "fields": oracle["fields"],
            "fields_free": oracle["fields_free"]}


def stats_chain(mods, data: str, out: str, tmp_dir: str, ks: bool = False,
                figures: bool = True, analysis_kw: dict | None = None
                ) -> tuple[dict, object]:
    """The user's chain of config/config_stats.yaml on ``data`` into
    ``out``, with the stages of ``mods`` = (stats_prep, label_prep,
    tilesets, stats_analysis) (either package's): ``prepare_data.py`` (the
    overlap-free road polygons and the restricted AOI),
    ``prepare_data_obj_detec.py`` (the z18 tiles over the roads'
    polygons), ``generate_tilesets.py`` (4-band tiles served by a
    ``BandsOpener`` over the written polygons, encoding through files in
    ``tmp_dir``; the YAML's debug cap of 100 tiles) and
    ``statistical_analysis.py`` at the YAML's ``param`` (``do_ks_test``
    set to ``ks``; with ``figures`` off, ``make_boxplots`` off too), with
    ``analysis_kw`` passed to its ``run``. Returns (each stage's
    seconds, the opener)."""
    import copy

    import yaml

    stats_prep, label_prep, tilesets, stats_analysis = mods
    with open(os.path.join(ROOT, "config", "config_stats.yaml")) as f:
        cfg = yaml.safe_load(f)
    s = {}
    t0 = time.perf_counter()
    sp = copy.deepcopy(cfg["prepare_data.py"])
    sp["input"]["input_folder"] = data
    sp["output_folder"] = out
    stats_prep.run(sp)
    s["stats_prep"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lp = copy.deepcopy(cfg["prepare_data_obj_detec.py"])
    lp["input"]["input_folder"] = data
    lp["output_folder"] = out
    label_prep.run(lp)
    s["label_prep"] = time.perf_counter() - t0

    from roadsurf_tpu_torch.io import read_file

    t0 = time.perf_counter()
    opener = BandsOpener(
        os.path.join(out, "json_inputs", "tiles_aoi.geojson"),
        read_file(os.path.join(out, "shapefiles_gpkg",
                               "roads_polygons_stats.shp")), 6, tmp_dir)
    s["mosaic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = copy.deepcopy(cfg["generate_tilesets.py"])
    ts["working_directory"] = out
    tilesets.run(ts, opener=opener)
    s["tilesets"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sa = copy.deepcopy(cfg["statistical_analysis.py"])
    sa["processed"]["processed_folder"] = out
    sa["final_folder"] = os.path.join(out, "final")
    sa["param"]["do_ks_test"] = ks
    if not figures:
        sa["param"]["make_boxplots"] = False
    stats_analysis.run(sa, **(analysis_kw or {}))
    s["stats_analysis"] = time.perf_counter() - t0
    return s, opener


def phase_tileset_path() -> dict:
    """The user's chain on the card's host, then training on what it wrote:
    ``pipeline.label_prep.run`` with the YAML's ``prepare_data_obj_detec.py``
    block on the synthetic scene (``write_scene``: a GRID x GRID jittered
    road grid, ~12 km of road a km², ten forests, a 3 km x 3 km AOI), then
    ``pipeline.tilesets.run`` with its ``generate_tilesets.py`` block, the
    tiles served as PNG bytes by ``MosaicOpener``, then
    ``pipeline.training.train`` for TILESET_STEPS steps on the written
    ``COCO_trn.json`` and ``trn-images/`` (the YAML's model at full width,
    B=8, multiscale, no eval). Checks: ground-truth plus other labels equal
    the labelled roads; every tile of ``split_aoi_tiles.geojson`` has its
    GeoTIFF in ``{ds}-images/`` and ``all-images/``, its pixels equal to
    what the opener served, and its ``img_metadata.json`` bounds equal to
    ``WebMercatorQuad.xy_bounds``; every COCO ring within [0, 256] with at
    least 6 values; ``labels_id.json`` read by ``pd.read_json(orient=
    "index")``; finite losses and STEP_LAUNCHES a step."""
    import copy
    import tempfile
    from dataclasses import replace

    import pandas as pd

    from roadsurf_tpu_torch.io import read_file, read_geotiff
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.ops.cuda_build import BUILD_DIR
    from roadsurf_tpu_torch.pipeline import label_prep, tilesets, training
    from roadsurf_tpu_torch.tiles import WebMercatorQuad, parse_tile_id
    from roadsurf_tpu_torch.utils.config import load_script_config

    yaml_path = os.path.join(ROOT, "config", "config_obj_detec.yaml")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        t0 = time.perf_counter()
        data = write_scene(root)
        scene_s = time.perf_counter() - t0
        lp_cfg = copy.deepcopy(load_script_config(
            yaml_path, "prepare_data_obj_detec.py"))
        lp_cfg["input"]["input_folder"] = data
        lp_cfg["output_folder"] = out = os.path.join(root, "outputs")
        lp_s = {}
        label_prep.run(lp_cfg, timings=lp_s)
        json_dir = os.path.join(out, "json_inputs")
        roads = read_file(os.path.join(out, "shapefiles_gpkg",
                                       "roads_for_OD.shp"))
        gt = read_file(os.path.join(json_dir, "ground_truth_labels.geojson"))
        oth_path = os.path.join(json_dir, "other_labels.geojson")
        n_oth = len(read_file(oth_path)) if os.path.exists(oth_path) else 0
        n_labelled = int(roads["BELAGSART"].isin([100, 200]).sum())
        _require(len(gt) + n_oth == n_labelled and len(gt) > 0,
                 f"GT {len(gt)} + OTH {n_oth} labels != {n_labelled} "
                 "labelled roads")

        ts_cfg = copy.deepcopy(load_script_config(yaml_path,
                                                  "generate_tilesets.py"))
        ts_cfg["working_directory"] = out
        t0 = time.perf_counter()
        opener = MosaicOpener(os.path.join(json_dir, "tiles_aoi.geojson"),
                              os.path.join(json_dir,
                                           "ground_truth_labels.geojson"), 4)
        mosaic_s = time.perf_counter() - t0
        ts_s = {}
        tilesets.run(ts_cfg, opener=opener, timings=ts_s)
        od = os.path.join(out, ts_cfg["output_folder"])
        split = read_file(os.path.join(od, "split_aoi_tiles.geojson"))
        with open(os.path.join(od, "img_metadata.json")) as f:
            meta = json.load(f)
        _require(len(meta) == len(split) == opener.served > 0,
                 f"{len(split)} tiles, {len(meta)} metadata entries, "
                 f"{opener.served} served")
        for tid, ds in zip(split["id"], split["dataset"]):
            t = parse_tile_id(tid)
            fn = WebMercatorQuad.tile_filename(t)
            r = read_geotiff(os.path.join(od, f"{ds}-images", fn))
            _require(os.path.exists(os.path.join(od, "all-images", fn))
                     and np.array_equal(r.data, opener.tile(t.x, t.y)),
                     f"tile {fn} of {ds} differs from what was served")
            _require(meta[fn]["bounds_3857"]
                     == list(WebMercatorQuad.xy_bounds(t)),
                     f"img_metadata.json bounds of {fn}")
        n_ann = {}
        for ds in tilesets.DATASETS:
            with open(os.path.join(od, f"COCO_{ds}.json")) as f:
                coco = json.load(f)
            n_ann[ds] = len(coco["annotations"])
            _require(all(len(ring) >= 6 and min(ring) >= 0
                         and max(ring) <= TILE
                         for a in coco["annotations"]
                         for ring in a["segmentation"]),
                     f"COCO_{ds}.json has a ring off the tile")
        labels_id = pd.read_json(os.path.join(od, "labels_id.json"),
                                 orient="index")
        _require(list(labels_id["id"]) == [1, 2]
                 and list(labels_id["name"]) == ["artificial", "natural"],
                 f"labels_id.json: {labels_id}")

        cfg = from_detectron2_yaml(os.path.join(ROOT, YAML))
        cfg = replace(cfg, max_iter=TILESET_STEPS, eval_period=10 ** 9,
                      checkpoint_period=10 ** 9)
        steps = []
        step_fn = _counting_steps(training, steps)
        try:
            _reset_counts()
            t0 = time.perf_counter()
            training.train(cfg, os.path.join(od, "COCO_trn.json"),
                           os.path.join(od, "trn-images"),
                           os.path.join(od, "logs"),
                           max_iter=TILESET_STEPS, batch_size=TB,
                           image_size=800, max_instances=16, log_every=1,
                           seed=7, multiscale=True)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = _read_counts()
        finally:
            training.train_step = step_fn
        with open(os.path.join(od, "logs", "metrics.jsonl")) as f:
            losses = [ln for ln in map(json.loads, f) if "total" in ln]
    _require(len(losses) == TILESET_STEPS and all(
        np.isfinite(ln[k]) for ln in losses for k in (
            "loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
            "loss_mask", "total")), f"losses not finite: {losses}")
    _require(len(steps) == TILESET_STEPS and all(
        s["launches"] == {k: STEP_LAUNCHES.get(k, 0) for k in s["launches"]}
        for s in steps), f"a step's launches differ from {STEP_LAUNCHES}: "
        f"{[s['launches'] for s in steps]}")
    n_tiles = len(split)
    res = {"phase": "tileset_path",
           "scene": {"grid": GRID, "spacing_m": SPACING, "jitter_m": JITTER,
                     "aoi_km2": (SCENE_SIDE / 1e3) ** 2,
                     "segments": 2 * GRID * (GRID - 1)},
           "reduced": {"aoi_km2": "9 of the reference's ~840 (time)",
                       "steps": TILESET_STEPS,
                       "weights": "random (init_params, seed 7)"},
           "scene_s": scene_s, "label_prep_s": lp_s,
           "mosaic_s": mosaic_s, "tilesets_s": ts_s,
           "roads": len(roads), "labels": {"gt": len(gt), "oth": n_oth},
           "tiles": n_tiles,
           "tiles_by_dataset": split["dataset"].value_counts().to_dict(),
           "annotations": n_ann,
           "tiles_written_per_s": n_tiles / ts_s["fetch"],
           "train_s": train_s, "steps": steps,
           "s_per_step": [s["ms"] / 1e3 for s in steps],
           "losses": losses, "launches": launches,
           "launches_per_step": STEP_LAUNCHES}
    _emit(res)
    return res


def _host_s_per_step(lines: list, batch: int) -> float:
    """Mean seconds a step over steps 2.. of metrics.jsonl lines written
    with log_every 1 (each line's imgs_per_sec is batch / its step's host
    time)."""
    return float(np.mean([batch / ln["imgs_per_sec"] for ln in lines[1:]]))


# ---------------------------------------------------------------------------
# data parallelism

DP_SIDE, DP_B, DP_STEPS = 320, 4, 2       # dp_train (a): fixed 320 px, B=4
DP_RUN_STEPS = 3                          # dp_train (b)


def _dp_batch(B: int, S: int, seed: int = 5) -> dict:
    """A global training batch of B synthetic S px tiles: 1 to 6 road-like
    polygons of both classes painted over noise, their boxes and
    full-tile masks (16 rows an image)."""
    from roadsurf_tpu_torch.geom import _native

    rng = np.random.default_rng(seed)
    G = 16
    out = {"image": rng.integers(60, 120, (B, S, S, 3)).astype(np.uint8),
           "gt_boxes": np.zeros((B, G, 4), np.float32),
           "gt_classes": np.zeros((B, G), np.int32),
           "gt_valid": np.zeros((B, G), bool),
           "gt_masks": np.zeros((B, G, S, S), np.uint8)}
    for b in range(B):
        for g, (cls, quad) in enumerate(_road_polygons(
                rng, int(rng.integers(1, 7)))):
            quad = quad * (S / TILE)
            m = _native.rasterize(_native.pack([[np.concatenate(
                [quad, quad[:1]])]]), 0.0, 1.0, 0.0, 1.0, S, S)
            out["image"][b][m > 0] = (200, 200, 190) if cls == 1 \
                else (150, 110, 60)
            out["gt_boxes"][b, g] = (*quad.min(0), *quad.max(0))
            out["gt_classes"][b, g] = cls - 1
            out["gt_valid"][b, g] = True
            out["gt_masks"][b, g] = m > 0
    return out


def phase_dp_train() -> dict:
    """dp_train (a): the port's data-parallel training step, two gloo ranks
    on cuda:0 (NCCL refuses two ranks on one device; gloo carries the
    collectives of the CUDA tensors, the card does the compute) against
    one rank in this process: the YAML's model at full width in float32
    (K2 and K5 in their float32 modes), TF32 off, fixed DP_SIDE px, a
    global batch of DP_B, DP_STEPS steps. Checks: every step's losses
    within 1e-4 + 1e-3·|ref|; the two ranks' parameters bitwise equal after
    the steps; a rank's step FLOPs (FlopCounterMode) at most 1.35/2 of the
    one-rank step's; each rank's launches DP_STEPS·STEP_LAUNCHES_F32."""
    from dataclasses import replace

    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.parallel.dryrun import LOSS_KEYS, compare_ranks

    cfg = replace(from_detectron2_yaml(os.path.join(ROOT, YAML)),
                  compute_dtype="float32")
    case = {"cfg": cfg, "image_size": DP_SIDE,
            "batch": _dp_batch(DP_B, DP_SIDE), "init_seed": 7, "seed": 7,
            "steps": DP_STEPS, "count_flops": True}
    _reset_counts()
    t0 = time.perf_counter()
    (one,), _, (ranks_res,), rank_counts = compare_ranks(
        [case], 2, device="cuda", backend="gloo")
    wall = time.perf_counter() - t0
    parent = _read_counts()
    want = {k: DP_STEPS * STEP_LAUNCHES_F32.get(k, 0) for k in parent}
    for who, counts in [("one rank", parent)] + [
            (f"rank {r}", c) for r, c in enumerate(rank_counts)]:
        _require(counts == want, f"dp_train {who}: launches {counts}, "
                                 f"expected {want}")
    # each step's worst loss difference in units of its tolerance
    worst = [max(abs(ranks_res[0]["metrics"][i][k] - one["metrics"][i][k])
                 / (1e-4 + 1e-3 * abs(one["metrics"][i][k]))
                 for k in LOSS_KEYS) for i in range(DP_STEPS)]
    _require(max(worst) <= 1.0, f"dp_train: losses beyond 1e-4 + 1e-3·|ref| "
                                f"(worst/tolerance by step {worst}): "
                                f"{one['metrics']} vs {ranks_res[0]['metrics']}")
    _require(ranks_res[0]["params_sha256"] == ranks_res[1]["params_sha256"],
             "dp_train: the ranks' parameters differ")
    ratio = ranks_res[0]["flops"][0] / one["flops"][0]
    _require(ratio <= 1.35 / 2, f"dp_train: FLOPs ratio {ratio}")
    res = {"phase": "dp_train",
           "what": "2 gloo ranks sharing cuda:0 (NCCL takes one rank a "
                   "device) vs 1 rank; the card computes, gloo carries "
                   "the collectives",
           "profile": f"from_detectron2_yaml({YAML!r}), float32, TF32 off",
           "image_size": DP_SIDE, "global_batch": DP_B, "steps": DP_STEPS,
           "loss_diff_over_tolerance": worst,
           "one_rank_losses": one["metrics"],
           "two_rank_losses": ranks_res[0]["metrics"],
           "params_bitwise_equal": True,
           "flops_one_rank": one["flops"][0],
           "flops_per_rank": ranks_res[0]["flops"][0],
           "per_device_flops_ratio": ratio,
           "step_s_one_rank": one["seconds"],
           "step_s_rank0": ranks_res[0]["seconds"],
           "wall_s": wall,
           "launches_per_rank": rank_counts,
           "launches": _sum_counts(parent, *rank_counts)}
    _emit(res)
    return res


def phase_dp_train_run(train_res: dict) -> dict:
    """dp_train (b): ``pipeline.training.run`` on the ``train_model.py``
    block over train_path's synthetic tileset, data-parallel over every
    visible card with NCCL (one rank a card: a real init, broadcast and
    all-reduce), the YAML's model in bf16, multiscale 640..800, B=8,
    DP_RUN_STEPS steps. Checks: finite losses, one metrics.jsonl line a
    step; each rank's launches DP_RUN_STEPS·STEP_LAUNCHES; one checkpoint,
    which ``TileInferenceEngine`` loads and answers a batch with. Numbers:
    host s/step and images/s beside train_path's (same clock), and the
    loader's seconds a global batch, which every rank pays."""
    import tempfile

    from roadsurf_tpu_torch.engine import TileInferenceEngine
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.ops.cuda_build import BUILD_DIR
    from roadsurf_tpu_torch.pipeline import training
    from roadsurf_tpu_torch.utils.weights import from_jax_params, \
        load_params

    n = torch.cuda.device_count()
    stats = {}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as wd:
        paths = _write_train_dataset(wd)
        block = {"working_directory": wd,
                 "detectron2_config_file": os.path.join(ROOT, YAML),
                 "COCO_files": {"trn": "COCO_trn.json",
                                "val": "COCO_val.json"},
                 "seed": 7}
        t0 = time.perf_counter()
        training.run(block, max_iter=DP_RUN_STEPS, batch_size=TB,
                     n_devices=n, backend="nccl", log_every=1,
                     device="cuda", stats=stats)
        run_s = time.perf_counter() - t0
        log_dir = os.path.join(wd, "logs")
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            lines = [json.loads(ln) for ln in f]
        ckpts = sorted(f for f in os.listdir(log_dir) if f.endswith(".npz"))
        tree, ck_step = load_params(os.path.join(log_dir, ckpts[0]))
        eng = TileInferenceEngine(from_jax_params(tree),
                                  from_detectron2_yaml(
                                      os.path.join(ROOT, YAML)),
                                  batch_size=TB, mask_format="bits")
        ds = training.CocoTileDataset(paths["trn"], paths["trn_images"], 16)
        out = next(eng.run([np.stack([ds.load(i)[0] for i in range(TB)])]))
        # the loader's cost a global batch (each rank builds all of it)
        rng = np.random.default_rng(0)
        loader = []
        for size in (640, 800):
            t1 = time.perf_counter()
            training.make_batch(ds, rng, rng.permutation(len(ds))[:TB],
                                target_size=size)
            loader.append(time.perf_counter() - t1)
    _require(len(lines) == DP_RUN_STEPS and all(
        np.isfinite(ln[k]) for ln in lines for k in (
            "loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
            "loss_mask", "total", "lr", "imgs_per_sec")),
        f"dp_train_run: losses {lines}")
    want = {k: DP_RUN_STEPS * STEP_LAUNCHES.get(k, 0)
            for k in stats["ranks"][0]["launches"]}
    _require(len(stats["ranks"]) == n and all(
        r["launches"] == want for r in stats["ranks"]),
        f"dp_train_run: launches {stats['ranks']}, expected {want} a rank")
    _require(ckpts == [f"model_{DP_RUN_STEPS - 1:07d}.npz"]
             and ck_step == DP_RUN_STEPS, f"dp_train_run: {ckpts}")
    _require(out["boxes"].shape == (TB, 100, 4) and bool(
        np.isfinite(out["boxes"]).all()), "dp_train_run: engine answer")
    s_step = _host_s_per_step(lines, TB)
    res = {"phase": "dp_train_run", "ranks": n, "backend": "nccl",
           "profile": f"from_detectron2_yaml({YAML!r}), bf16, multiscale",
           "batch": TB, "steps": DP_RUN_STEPS, "run_s": run_s,
           "losses": lines, "host_s_per_step": s_step,
           "images_per_s": TB / s_step,
           "train_path_host_s_per_step": train_res["host_s_per_step"],
           "train_path_images_per_s": TB / train_res["host_s_per_step"],
           "loader_s_per_global_batch": {"640": loader[0],
                                         "800": loader[1]},
           "checkpoint": ckpts[0],
           "launches_per_rank": [r["launches"] for r in stats["ranks"]],
           "launches": _sum_counts(*[r["launches"]
                                     for r in stats["ranks"]])}
    _emit(res)
    return res


def phase_dp_infer() -> dict:
    """dp_infer: the sharded ``TileInferenceEngine`` (every card, or two
    shards on cuda:0 when there is one card) on the parity profile in
    float32 (K2 in its float32 mode), B=16, bits, random weights; two
    batches of 16 and a tail of 9 after a warm-up batch; K2 and K3 twice a
    shard and batch. Checks: its outputs equal, bit for bit, those of a
    one-device engine at the shard's batch size fed the same rows (the
    same padded tail). Beside it, the one-device engine at B=16: with
    random weights every parity slot is valid and the forward at batch 8
    and 16 (other conv algorithms) may order near-equal scores
    differently, so the flips of valid flags or classes and the boxes
    beyond rtol 1e-2, atol 0.5 are counted for the sharded and the
    batch-8 engine alike, not required to be 0."""
    from dataclasses import replace

    from roadsurf_tpu_torch.engine import TileInferenceEngine
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n)] if n > 1 \
        else ["cuda:0", "cuda:0"]
    b = PB // len(devices)
    cfg = replace(from_detectron2_yaml(os.path.join(ROOT, YAML)),
                  compute_dtype="float32")
    state = from_jax_params(_random_tree(cfg, torch.Generator()
                                         .manual_seed(11)))
    rng = np.random.default_rng(4)
    warm = rng.integers(0, 255, (PB, TILE, TILE, 3), np.uint8)
    batches = [rng.integers(0, 255, (k, TILE, TILE, 3), np.uint8)
               for k in (PB, PB, PB // 2 + 1)]

    def shard_rows(batch):
        """The batch padded as the engine pads it, in shards of b rows."""
        pad = np.zeros((PB - len(batch),) + batch.shape[1:], np.uint8)
        full = np.concatenate([batch, pad])
        return [full[i:i + b] for i in range(0, PB, b)]

    runs = {"sharded": (devices, PB, batches),
            "one_shard": (devices[:1], b,
                          [c for x in batches for c in shard_rows(x)]),
            "one": (devices[:1], PB, batches)}
    out, tps, counts = {}, {}, {}
    for label, (devs, bs, feed) in runs.items():
        eng = TileInferenceEngine(state, cfg, batch_size=bs, devices=devs,
                                  mask_format="bits")
        _require(len(eng.replicas) == len(devs), f"{label}: replicas")
        list(eng.run(iter(shard_rows(warm) if bs < PB else [warm])))
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out[label] = list(eng.run(iter(feed)))
        tps[label] = sum(len(x) for x in batches) \
            / (time.perf_counter() - t0)
        counts[label] = _read_counts()
        forwards = len(devs) * len(feed)
        want = {k: 0 for k in counts[label]}
        want.update({"roi_align_blocked_f32": 2 * forwards,
                     "nms": 2 * forwards})
        _require(counts[label] == want,
                 f"dp_infer {label}: launches {counts[label]}, want {want}")
        del eng
    # the batch-8 engine's outputs regrouped as the sharded engine's
    per = len(devices)
    regrouped = [{k: np.concatenate([o[k] for o in out["one_shard"][
        i * per:(i + 1) * per]])[:len(x)] for k in out["one_shard"][0]}
        for i, x in enumerate(batches)]
    for got, want in zip(out["sharded"], regrouped):
        for k in want:
            _require(np.array_equal(got[k], want[k]),
                     f"dp_infer: {k} of the sharded engine differs from "
                     "the one-device engine at the shard's batch size")

    def against_b16(res):
        pairs = list(zip(res, out["one"]))
        return {"valid_or_class_flips": sum(
                    int((x["valid"] != y["valid"]).sum()
                        + (x["classes"] != y["classes"]).sum())
                    for x, y in pairs),
                "boxes_beyond_rtol_1e-2_atol_0.5": sum(
                    int((np.abs(x["boxes"] - y["boxes"])
                         > 0.5 + 1e-2 * np.abs(y["boxes"])).sum())
                    for x, y in pairs),
                "max_box_diff_px": max(float(np.abs(
                    x["boxes"] - y["boxes"]).max()) for x, y in pairs)}

    res = {"phase": "dp_infer", "devices": devices,
           "profile": f"from_detectron2_yaml({YAML!r}), float32",
           "batch": PB, "shard": b,
           "tiles": sum(len(x) for x in batches),
           "equal_to_one_device_at_shard_batch": True,
           "valid": int(sum(o["valid"].sum() for o in out["sharded"])),
           "against_one_device_b16": {"sharded": against_b16(
               out["sharded"]), "one_device_b8": against_b16(regrouped)},
           "tiles_per_s": tps,
           "launches_by_engine": counts, "launches": counts["sharded"]}
    _emit(res)
    return res


# ---------------------------------------------------------------------------
# the multi-batch dispatch: CUDA graphs of k forwards or k training steps

# bench.py:80-90's scan_k: 16 for the fast profile, 4 for the parity one;
# scripts/bench_training.py's k for training steps
SCAN_K_FAST, SCAN_K_PARITY, SCAN_K_TRAIN = 16, 4, 4
SCAN_TRAIN_SIDE, SCAN_TRAIN_B = 800, 8
# kernel name -> count name, for the kernels a profiler window shows (K1
# and K2 share their device code: K1 on the fast paths, K2 on the parity
# and training paths; a K3 launch is one pair and one sweep kernel)
PROFILED = {"roi_align_staged_kernel": "pooler",
            "nms_sweep_kernel": "nms",
            "roi_align_backward_tile_kernel": "roi_align_backward",
            "bias_act_elementwise_kernel": "bias_act"}


def _profiled_launches(kernels) -> dict:
    """Launches by kernel in a profiler window, from the kernels' names."""
    out = {v: 0 for v in PROFILED.values()}
    for name, _, count in kernels:
        for key, label in PROFILED.items():
            if key in name:
                out[label] += count
    return out


def _main_tiles(batch: int, sizes: list) -> list:
    """The random tiles ``_drive`` gives a main path of these sizes."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (n, TILE, TILE, 3), np.uint8)
            for n in sizes]


def _equal_outputs(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        sorted(x) == sorted(y) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in y) for x, y in zip(a, b))


def _scan_engine_case(label: str, cfg, batch: int, k: int, sizes: list,
                      mask_format: str, per_batch: dict, pooler: str
                      ) -> dict:
    """One profile through ``TileInferenceEngine`` at ``scan_k`` k and at
    1, one state and one set of weights (``_drive``'s): over the main
    path's tiles (``sizes``) the outputs bit for bit equal and the
    launches ``per_batch`` for every batch a group runs (the tail group's
    empty ones included); over 2k full batches tiles/s from CUDA events;
    over one group (k batches) the profiler's device split and the
    launches read from its kernel names, held equal to the counters';
    the graph's capture seconds and memory pool."""
    from roadsurf_tpu_torch.engine import TileInferenceEngine
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    state = from_jax_params(_random_tree(cfg, torch.Generator()
                                         .manual_seed(0)))
    tiles = _main_tiles(batch, sizes)
    rng = np.random.default_rng(1)
    timing = [rng.integers(0, 256, (batch, TILE, TILE, 3), np.uint8)
              for _ in range(2 * k)]
    runs, outs = {}, {}
    for scan_k in (k, 1):
        eng = TileInferenceEngine(state, cfg, batch_size=batch,
                                  mask_format=mask_format, scan_k=scan_k)
        t0 = time.perf_counter()
        list(eng.run(iter(timing[:scan_k])))       # warm-up (the capture)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _reset_counts()
        plain0 = _plain_convs()
        outs[scan_k] = list(eng.run(iter(tiles)))
        torch.cuda.synchronize()
        counts = _read_counts()
        ran = -(-len(tiles) // scan_k) * scan_k
        want = {c: per_batch.get(c, 0) * ran for c in counts}
        _require(counts == want and _plain_convs() == plain0,
                 f"scan_path {label} scan_k={scan_k}: launches {counts}, "
                 f"expected {want}; {_plain_convs() - plain0} plain convs")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        list(eng.run(iter(timing)))
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        before = _read_counts()
        kernels, wall = _device_kernels(
            lambda: list(eng.run(iter(timing[:k]))))
        after = _read_counts()
        seen = _profiled_launches(kernels)
        counted = {c: after[c] - before[c] for c in after
                   if after[c] != before[c]}
        # the epilogue's launches the profiler saw are reported, not held
        # to the counters: CUPTI lost 1 of 1232 records of a replay once
        _require(seen["pooler"] == counted.get(pooler, 0) == 2 * k
                 and seen["nms"] == counted.get("nms", 0)
                 == per_batch.get("nms", 0) * k,
                 f"scan_path {label} scan_k={scan_k}: the profiler saw "
                 f"{seen}, the counters {counted}, over {k} batches")
        graph = eng.replicas[0].graph
        runs[f"scan_k_{scan_k}"] = {
            "tiles_per_s": batch * len(timing) / (ms / 1e3),
            "event_ms": ms, "first_call_s": first_s,
            "launches": counts, "profiled_launches": seen,
            "capture_s": graph.capture_s if graph else None,
            "graph_pool_bytes": graph.pool_bytes if graph else None,
            "graph_launches": graph.launches if graph else None,
            "h2d_s": eng.stats["h2d_s"], "d2h_s": eng.stats["d2h_s"],
            **_split(kernels, wall)}
        del eng
        torch.cuda.empty_cache()
    _require(_equal_outputs(outs[k], outs[1]),
             f"scan_path {label}: scan_k={k} differs from scan_k=1")
    return {"case": label, "batch": batch, "scan_k": k,
            "mask_format": mask_format, "batches": sizes,
            "timed_batches": len(timing), "bitwise_equal_to_scan_k_1": True,
            "launches": runs[f"scan_k_{k}"]["launches"], **runs}


def _scan_sharded_case() -> dict:
    """The sharded engine (two replicas on cuda:0, fast profile, B=64) at
    scan_k 4 against one device's engine at the shard's batch (32) and
    scan_k 4 fed the shards' rows: bit for bit, as ``dp_infer`` holds the
    eager engines."""
    from roadsurf_tpu_torch.engine import TileInferenceEngine
    from roadsurf_tpu_torch.models import fast_profile
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    cfg = fast_profile(post_nms_topk=32)
    k, b = SCAN_K_PARITY, B // 2
    state = from_jax_params(_random_tree(cfg, torch.Generator()
                                         .manual_seed(0)))
    tiles = _main_tiles(B, [B] * 6 + [40])

    def shard_rows(x):
        full = np.concatenate([x, np.zeros((B - len(x),) + x.shape[1:],
                                           np.uint8)])
        return [full[:b], full[b:]]

    feed = {"sharded": (["cuda:0", "cuda:0"], B, tiles),
            "one_device": (["cuda:0"], b,
                           [r for x in tiles for r in shard_rows(x)])}
    out, counts, tps, graphs = {}, {}, {}, {}
    for label, (devs, bs, batches) in feed.items():
        eng = TileInferenceEngine(state, cfg, batch_size=bs, devices=devs,
                                  scan_k=k)
        list(eng.run(iter(batches[:k])))            # warm-up (the captures)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out[label] = list(eng.run(iter(batches)))
        torch.cuda.synchronize()
        tps[label] = sum(len(x) for x in tiles) / (time.perf_counter() - t0)
        counts[label] = _read_counts()
        ran = -(-len(batches) // k) * k * len(devs)
        want = {c: {"roi_align": 2, "bias_act": EPILOGUE}.get(c, 0) * ran
                for c in counts[label]}
        _require(counts[label] == want, f"scan_path sharded {label}: "
                 f"launches {counts[label]}, expected {want}")
        graphs[label] = [{"capture_s": r.graph.capture_s,
                          "graph_pool_bytes": r.graph.pool_bytes}
                         for r in eng.replicas]
        del eng
    regrouped = [{key: np.concatenate([o[key] for o in out["one_device"][
        2 * i:2 * i + 2]])[:len(x)] for key in out["one_device"][0]}
        for i, x in enumerate(tiles)]
    _require(_equal_outputs(out["sharded"], regrouped),
             "scan_path: the sharded engine at scan_k 4 differs from one "
             "device's at the shard's batch")
    return {"case": "sharded", "devices": ["cuda:0", "cuda:0"], "batch": B,
            "shard": b, "scan_k": k, "bitwise_equal_to_one_device": True,
            "tiles_per_s": tps, "graphs": graphs,
            "launches_by_engine": counts, "launches": counts["sharded"]}


def _leaves_equal(a, b) -> bool:
    from roadsurf_tpu_torch.engine.train import leaves

    return all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a),
                                                           leaves(b)))


def _scan_train_case() -> dict:
    """``make_train_scan_step`` (the YAML's model at full width, bf16,
    800 px, B=8, k=4) against 4 single steps of ``train_step``, from copies
    of one state, with each step's draws from its generator, under
    ``cudnn.deterministic``: parameters, velocity and the last step's
    metrics bit for bit (else the training step tests' tolerances, with
    the eager steps' own repeatability beside them), twice (steps 0-3 and
    4-7). s/step of both from CUDA events, the launches a scan from the
    profiler's kernel names and the counters, the graph's capture seconds
    and pool."""
    from roadsurf_tpu_torch.engine import train as tt
    from roadsurf_tpu_torch.models import init_params
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.utils.weights import from_jax_train_params

    cfg = from_detectron2_yaml(os.path.join(ROOT, YAML))
    k, S, Bt = SCAN_K_TRAIN, SCAN_TRAIN_SIDE, SCAN_TRAIN_B
    params = from_jax_train_params(init_params(cfg, torch.Generator()
                                               .manual_seed(7)))

    def fresh():
        return tt.init_train_state(params, cfg, seed=7, device="cuda")

    raw = [_dp_batch(Bt, S, seed=20 + i) for i in range(2 * k)]
    dev = [{n: torch.from_numpy(v).cuda() for n, v in b.items()}
           for b in raw]
    stacked = [{n: torch.stack([d[n] for d in dev[j:j + k]])
                for n in dev[0]} for j in (0, k)]
    step = tt.train_step(cfg, S)
    scan = tt.make_train_scan_step(cfg, S, k)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        step(fresh(), dev[0])                      # warm the eager step
        single, scanned, again = fresh(), fresh(), fresh()
        rounds = []
        for j in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(k):
                one_m = step(single, dev[j * k + i])
            end.record()
            torch.cuda.synchronize()
            single_ms = start.elapsed_time(end)
            for i in range(k):
                again_m = step(again, dev[j * k + i])
            t0 = time.perf_counter()
            start.record()
            scan_m = scan(scanned, stacked[j])
            end.record()
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
            graph = scan.graphs[(Bt, 16)].graph
            rounds.append({
                "steps": [j * k, j * k + k - 1],
                "single_s_per_step": single_ms / 1e3 / k,
                "scanned_s_per_step": start.elapsed_time(end) / 1e3 / k,
                "call_s": call_s,
                "params_bitwise": _leaves_equal(scanned["params"],
                                                single["params"]),
                "velocity_bitwise": _leaves_equal(scanned["velocity"],
                                                  single["velocity"]),
                "metrics_bitwise": all(torch.equal(scan_m[n], one_m[n])
                                       for n in one_m),
                "eager_repeat_bitwise": _leaves_equal(again["params"],
                                                      single["params"]),
                "last_losses": {n: float(v) for n, v in scan_m.items()}})
        before = _read_counts()
        kernels, wall = _device_kernels(lambda: scan(scanned, stacked[0]))
        after = _read_counts()
        eager_kernels, eager_wall = _device_kernels(
            lambda: [step(single, dev[i]) for i in range(k)])
    finally:
        torch.backends.cudnn.deterministic = saved
    bitwise = all(r["params_bitwise"] and r["velocity_bitwise"]
                  and r["metrics_bitwise"] for r in rounds)
    worst = {}
    if not bitwise:
        # the training step tests' tolerances (tests/test_torch_train_
        # step.py): losses rtol 1e-5, velocity 1e-4·max|v| a leaf
        for (path, v), (_, w) in zip(tt.leaves(scanned["velocity"]),
                                     tt.leaves(single["velocity"])):
            scale = float(w.abs().max())
            if scale:
                worst[str(path)] = float((v - w).abs().max()) / scale
        loss = max(abs(float(scan_m[n]) - float(one_m[n]))
                   / (1e-6 + 1e-5 * abs(float(one_m[n]))) for n in one_m)
        _require(max(worst.values()) <= 1e-4 and loss <= 1.0,
                 f"scan_path training: beyond the step tests' tolerances: "
                 f"velocity {max(worst.values())}, losses {loss}; {rounds}")
    counted = {c: after[c] - before[c] for c in after}
    want = {c: k * STEP_LAUNCHES.get(c, 0) for c in after}
    seen = _profiled_launches(kernels)
    _require(counted == want and seen == {
        "pooler": want["roi_align_blocked"], "nms": want["nms"],
        "roi_align_backward": want["roi_align_backward"], "bias_act": 0},
        f"scan_path training: the counters {counted} and the profiler "
        f"{seen} a scan, expected {want}")
    return {"case": "train", "profile": f"from_detectron2_yaml({YAML!r})",
            "image_size": S, "batch": Bt, "scan_k": k,
            "cudnn_deterministic": True, "bitwise_equal": bitwise,
            "worst_velocity_over_max": max(worst.values()) if worst else 0.0,
            "rounds": rounds, "capture_s": graph.capture_s,
            "graph_pool_bytes": graph.pool_bytes,
            "graph_launches": graph.launches,
            "profiled_launches": seen, "launches": counted,
            "scanned": _split(kernels, wall),
            "single": _split(eager_kernels, eager_wall)}


def phase_scan_path() -> dict:
    """scan_path: the multi-batch dispatch, each part a JSON line. (a) the
    fast profile (bf16, B=64) through the engine at scan_k 16 and 1; (b)
    the parity profile (bf16, B=16, bits) at scan_k 4 and 1; (c) the
    sharded engine at scan_k 4; (d) ``make_train_scan_step`` at k=4
    against single steps."""
    from roadsurf_tpu_torch.models import fast_profile
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml

    t0 = time.perf_counter()
    parts = [
        _scan_engine_case("fast", fast_profile(post_nms_topk=32), B,
                          SCAN_K_FAST, [B] * 6 + [40], "logits",
                          {"roi_align": 2, "bias_act": EPILOGUE},
                          "roi_align"),
        _scan_engine_case("parity", from_detectron2_yaml(
            os.path.join(ROOT, YAML)), PB, SCAN_K_PARITY, [PB] * 3 + [9],
            "bits", {"roi_align_blocked": 2, "nms": 2, "bias_act": EPILOGUE},
            "roi_align_blocked")]
    for part in parts:
        _emit({"phase": "scan_path", **part})
    torch.cuda.empty_cache()
    parts.append(_scan_sharded_case())
    _emit({"phase": "scan_path", **parts[-1]})
    torch.cuda.empty_cache()
    parts.append(_scan_train_case())
    _emit({"phase": "scan_path", **parts[-1]})
    res = {"phase": "scan_path", "seconds": time.perf_counter() - t0,
           "launches": _sum_counts(*[p["launches"] for p in parts])}
    _emit(res)
    return res


# ---------------------------------------------------------------------------
# float32 forwards

F32_TILES = {"fast": 4, "parity": 2}
# the CPU parity tests' narrow heads (tests/test_torch_port_parity.py)
F32_NARROW = {"fpn_channels": 32, "box_fc_dim": 64, "mask_conv_dim": 32}
# the CPU parity tests' mask-logit tolerance, 1e-4 at their logits, whose
# largest magnitude is 6.40 (tests/test_torch_port_model.py's forward at 64
# px; tests/test_torch_float32_checks.py holds this scale to it), kept
# relative to the logits' scale: these random weights give logits of
# magnitude ~500, whose f32 ulp is 6e-5
MASK_ABS, MASK_LOGIT_SCALE = 1e-4, 6.4


def _plain_route():
    """A context in which the poolers and the NMS run their plain versions
    on CUDA tensors too (K1, K2 and K3 replaced where ``ops/roi_align.py``
    and ``ops/nms.py`` call them): the route a forward is held against."""
    import contextlib

    from roadsurf_tpu_torch.ops import nms as tnms
    from roadsurf_tpu_torch.ops import roi_align as tra
    from roadsurf_tpu_torch.ops.nms_kernel import nms_keep_mask_ref

    plain = {(tra, "roi_align_fused"): tra.roi_align_fused_ref,
             (tra, "roi_align_fused_blocked"):
                 tra.roi_align_fused_blocked_ref,
             (tnms, "nms_keep_mask"): nms_keep_mask_ref}

    @contextlib.contextmanager
    def ctx():
        saved = {k: getattr(*k) for k in plain}
        try:
            for (mod, name), fn in plain.items():
                setattr(mod, name, fn)
            yield
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)

    return ctx()


def phase_f32_forward() -> dict:
    """The fast and the parity profile in float32 (random weights, the CPU
    parity tests' narrow heads on the full ResNet-50, TF32 off) through
    ``forward_inference`` on a few random 256 px tiles, through
    the kernels (K1, or K2 and K3, in their float32 modes) and through the
    plain route (``_plain_route``) on the same inputs. Checks, the CPU
    parity tests' tolerances: valid flags and classes equal, boxes within
    1e-4 px and mask logits within 1e-4·max(1, max|logit| / 6.4) where
    valid (1e-4 at the CPU tests' logit magnitudes); the kernels' launches
    (K1 twice, or K2 twice and K3 twice) in the kernel route, none in the
    plain one."""
    from dataclasses import replace

    from roadsurf_tpu_torch.models import fast_profile, forward_inference
    from roadsurf_tpu_torch.models.config import from_detectron2_yaml
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    profiles = {
        "fast": (fast_profile(post_nms_topk=32), {"roi_align_f32": 2}),
        "parity": (from_detectron2_yaml(os.path.join(ROOT, YAML)),
                   {"roi_align_blocked_f32": 2, "nms": 2})}
    res = {"phase": "f32_forward", "launches": None, "profiles": {}}
    total = None
    for name, (cfg, expect) in profiles.items():
        cfg = replace(cfg, compute_dtype="float32", **F32_NARROW)
        state = from_jax_params(_random_tree(cfg, torch.Generator()
                                             .manual_seed(3)))
        tiles = np.random.default_rng(8).integers(
            0, 255, (F32_TILES[name], TILE, TILE, 3), np.uint8)
        _reset_counts()
        got = forward_inference(state, tiles, cfg, device="cuda")
        torch.cuda.synchronize()
        counts = _read_counts()
        with _plain_route():
            ref = forward_inference(state, tiles, cfg, device="cuda")
        torch.cuda.synchronize()
        plain_counts = _read_counts()
        want = {k: expect.get(k, 0) for k in counts}
        _require(counts == want and plain_counts == want,
                 f"f32_forward {name}: launches {counts}, then {plain_counts}"
                 f" with the plain route, want {want}")
        valid = ref["valid"]
        box_err = float((got["boxes"] - ref["boxes"]).abs()[valid].max())
        mask_err = float((got["mask_logits"] - ref["mask_logits"])
                         .abs()[valid].max())
        top = float(ref["mask_logits"].abs()[valid].max())
        mask_tol = MASK_ABS * max(1.0, top / MASK_LOGIT_SCALE)
        case = {"profile": name, "tiles": F32_TILES[name],
                "valid": int(valid.sum()),
                "valid_equal": bool(torch.equal(got["valid"], valid)),
                "classes_equal": bool(torch.equal(got["classes"],
                                                  ref["classes"])),
                "max_box_err_px": box_err, "max_mask_logit_err": mask_err,
                "max_abs_mask_logit": top, "mask_logit_tol": mask_tol,
                "max_score_err": float((got["scores"] - ref["scores"])
                                       .abs()[valid].max()),
                "launches": counts}
        res["profiles"][name] = case
        _require(case["valid_equal"] and case["classes_equal"]
                 and box_err <= 1e-4 and mask_err <= mask_tol
                 and int(valid.sum()) > 0,
                 f"f32_forward {name}: the kernels' forward disagrees with "
                 f"the plain route: {case}")
        total = counts if total is None else _sum_counts(total, counts)
        del state, got, ref
        torch.cuda.empty_cache()
    res["launches"] = total
    _emit(res)
    return res


# ---------------------------------------------------------------------------
# the quality path: weights trained on the card

SMOKE_STEPS = 500               # learning smoke (tools/learning_smoke.py)
CONTROL_STEPS = 51              # its control: the weights held at their init
QUALITY_ITERS = 600             # the chain's training (tools/quality.py)
# the gates: the learning smoke's last 50 totals' mean below 0.2x its first
# total and below 1.0, at least 12 of 16 instances found; each profile's
# balanced F1 at least 0.15 over the baseline's (far below the reference's
# 5-seed means, so that seed noise does not trip them: they catch a port
# that does not learn, or a scoring stage that is wrong). The loss gate
# lies between the readings of a sound run (the reference's own 500 steps
# end at 0.144x their first total on the CPU, the port's at 0.142x on the
# card) and the control, whose ratio must lie above it. The script's
# docstring has the total fall from ~80 to below 1, but both packages
# start at ~4.5, so a fall to 0.1x (~0.45) is not reached by either
SMOKE_LOSS_RATIO, SMOKE_MAX_LOSS = 0.2, 1.0
SMOKE_MIN_FOUND, F1_OVER_BASELINE = 12, 0.15


def phase_quality_path(wd: str) -> dict:
    """quality_path: the port's first runs with weights it trained. (1)
    ``tools.learning_smoke.run``: 500 SGD steps from scratch on synthetic
    rectangles at 64 px, B=16, then the scoring of 8 test tiles; gates: the
    mean of the last 50 totals below 0.2x the first step's total and below
    1.0, at least 12 of the 16 instances found; the same smoke with the
    weights held at their init (51 steps, base lr 0) must end above 0.2x
    its first total, so that the gate separates learning from none. (2)
    ``tools.quality.run`` in ``wd``, a
    directory under ``_build/``: label preparation, tilesets from the
    synthetic tile service (hard mode), 600 training steps at B=8 on 256
    px tiles, the validation tileset's COCO AP, make_detections with the
    checkpoint and the final metrics under the fast and the exact profile;
    gate: each profile's "all datasets" balanced F1 at least 0.15 over the
    baseline's. Both count their launches (training: K1 forward, K5
    backward; the exact profile: K3); K1, K3 and K5 must each have run.
    The chain runs in ``wd``, which ``ablation_path`` then reuses."""
    from roadsurf_tpu_torch.tools import learning_smoke, quality

    _reset_counts()
    t0 = time.perf_counter()
    smoke = learning_smoke.run(steps=SMOKE_STEPS, device="cuda")
    smoke_s = time.perf_counter() - t0
    smoke_counts = _read_counts()
    totals = smoke.pop("totals")
    first, last50 = totals[0], float(np.mean(totals[-50:]))
    res = {"phase": "quality_path",
           "smoke": {**smoke, "wall_s": smoke_s, "first_total": first,
                     "last50_mean_total": last50,
                     "launches": smoke_counts}}
    _require(all(np.isfinite(totals)) and last50 < SMOKE_LOSS_RATIO * first
             and last50 < SMOKE_MAX_LOSS
             and smoke["found"] >= SMOKE_MIN_FOUND,
             f"quality_path: the learning smoke missed its gates "
             f"(last 50 mean {last50} vs first {first}; found "
             f"{smoke['found']}): {res['smoke']}")
    control = learning_smoke.run(steps=CONTROL_STEPS, device="cuda",
                                 learn=False)["totals"]
    res["control"] = {"steps": CONTROL_STEPS, "first_total": control[0],
                      "last50_mean_total": float(np.mean(control[-50:])),
                      "ratio": float(np.mean(control[-50:])) / control[0]}
    _require(res["control"]["ratio"] > SMOKE_LOSS_RATIO,
             f"quality_path: the loss gate does not separate the smoke from "
             f"its control without learning: {res['control']}")
    res["smoke"]["ratio"] = last50 / first

    _reset_counts()
    chain = quality.run(wd, iters=QUALITY_ITERS, batch=8, device="cuda")
    chain_counts = _read_counts()
    curve = chain.pop("train_curve")
    res["chain"] = {**chain, "launches": chain_counts,
                    "train_totals": {ln["iter"]: ln["total"]
                                     for ln in curve}}
    res["launches"] = _sum_counts(smoke_counts, chain_counts)
    _emit(res)
    for prof in ("fast", "exact"):
        m = chain[prof]
        _require(m["balanced_f1_all"] >= m["baseline_f1"] + F1_OVER_BASELINE,
                 f"quality_path: the {prof} profile's balanced F1 "
                 f"{m['balanced_f1_all']} is not {F1_OVER_BASELINE} over the "
                 f"baseline's {m['baseline_f1']}")
    for k in ("roi_align", "nms", "roi_align_backward", "bias_act"):
        _require(res["launches"][k] > 0,
                 f"quality_path: {k} never launched: {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# the ablations: the seeded quality variants and make_detections measured,
# on weights trained on the card

# the variant of tools/ablate_seeded.py the phase scores: the fast int8
# stack (K1 int8)
ABLATION_VARIANTS = ("fast-R32+int8pyr",)
MASK_DELTA_MAX = 0.02           # |F1(bits) - F1(u8)|, paired: the same weights
MEASURE_TILES, MEASURE_BATCH, MEASURE_SCAN_K = 256, 256, 4
ABLATION_KERNELS = ("roi_align", "roi_align_int8", "bias_act")


def _record_keys(records: list) -> list:
    from roadsurf_tpu_torch.io import wkb

    return [(wkb.dumps(r["geometry"]), r["score"], r["det_class"])
            for r in records]


def _training_files(root: str) -> dict:
    """{path: (size, mtime_ns)} of every checkpoint and metrics log under
    ``root``: what a training step writes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if (f.startswith("model_") and f.endswith(".npz")) \
                    or f == "metrics.jsonl":
                st = os.stat(os.path.join(d, f))
                out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def phase_ablation_path(wd: str) -> dict:
    """ablation_path: the seeded ablations and make_detections measured,
    in ``quality_path``'s workdir ``wd`` (its scene is reused). (1)
    ``tools.ablate_seeded.run``: one seed, ``quality_path``'s checkpoint
    placed as seed 0's last (the same recipe, ``quality_config(600)``, 600
    steps at B=8 on 256 px tiles; the seed's training resumes there and
    takes no step), scored under ``ABLATION_VARIANTS`` (make_detections
    and final_metrics); gates: the seed took no step (no checkpoint
    written or rewritten anywhere under the workdir, every metrics log as
    it was or new and empty: a change of the tool's log layout, which
    would train the seed anew, fails here), and fast-R32+int8pyr's balanced F1 at least
    ``F1_OVER_BASELINE`` over the baseline's, as ``quality_path`` holds
    the bf16 profiles. (2)
    ``tools.ablate_mask_bits.run`` on that seed: the u8 and the bits
    downlink, paired; gate: |delta| <= ``MASK_DELTA_MAX``. (3)
    ``tools.measure_detections.run`` over 256 copies of the training tiles
    with the seed's checkpoint at B=256, its inputs scaled as it was
    trained (``from_scratch``; at the script's unit std the checkpoint
    fires ~12 detections over 512 tiles): scan_k 1 (profiled: the
    device's busy share), scan_k 4 (CUDA graphs) and the int8 stack;
    gates: records > 0, and the records at scan_k 4 equal to scan_k 1's.
    K1 in bf16 and int8 must each have launched."""
    from roadsurf_tpu_torch.tools import (ablate_mask_bits, ablate_seeded,
                                          measure_detections)

    import shutil

    od = os.path.join(wd, "outputs", "obj_detector")
    last = f"model_{QUALITY_ITERS - 1:07d}.npz"
    os.makedirs(os.path.join(od, "logs_seed0"), exist_ok=True)
    shutil.copy(os.path.join(od, "logs", last),
                os.path.join(od, "logs_seed0", last))
    trained = _training_files(od)
    _reset_counts()
    t0 = time.perf_counter()
    seeded = ablate_seeded.run(wd, seeds=1, iters=QUALITY_ITERS,
                               variants=list(ABLATION_VARIANTS),
                               device="cuda")
    seeded_s = time.perf_counter() - t0
    written = {p: v for p, v in _training_files(od).items()
               if trained.get(p) != v
               and not (p.endswith("metrics.jsonl") and p not in trained
                        and v[0] == 0)}
    _require(not written,
             f"ablation_path: the seed trained instead of resuming at "
             f"{last}: {sorted(written)}")
    t0 = time.perf_counter()
    mask = ablate_mask_bits.run(wd, seeds=1, device="cuda")
    mask_s = time.perf_counter() - t0
    images, ckpt = os.path.join(od, "trn-images"), os.path.join(
        od, "logs_seed0")
    measured, recs = {}, {}
    for label, kw in (("scan1", {"profile": True}),
                      (f"scan{MEASURE_SCAN_K}", {"scan_k": MEASURE_SCAN_K}),
                      ("int8", {"int8": True})):
        recs[label] = []
        measured[label] = measure_detections.run(
            images, ckpt, n_tiles=MEASURE_TILES, batch=MEASURE_BATCH,
            device="cuda", records=recs[label], from_scratch=True, **kw)
    counts = _read_counts()
    datasets = sorted(
        f[len("COCO_"):-len(".json")] for f in os.listdir(od)
        if f.startswith("COCO_") and f.endswith(".json"))
    res = {"phase": "ablation_path", "rows": seeded["rows"],
           "summary": seeded["summary"], "seeded_s": seeded_s,
           "mask_bits": mask, "mask_bits_s": mask_s,
           "measure_detections": measured, "datasets": datasets,
           "launches": counts}
    _emit(res)
    rows = {r["variant"]: r for r in seeded["rows"]}
    fast = rows["fast-R32+int8pyr"]
    _require(fast["f1b"] >= fast["baseline_f1"] + F1_OVER_BASELINE,
             f"ablation_path: fast-R32+int8pyr's balanced F1 {fast['f1b']} "
             f"is not {F1_OVER_BASELINE} over the baseline's "
             f"{fast['baseline_f1']}")
    _require(mask["max_abs_delta"] <= MASK_DELTA_MAX,
             f"ablation_path: the bits downlink moved the F1 by "
             f"{mask['max_abs_delta']} > {MASK_DELTA_MAX}: {mask}")
    _require(all(m["records"] > 0 for m in measured.values()),
             f"ablation_path: a measurement found no records: {measured}")
    _require(_record_keys(recs[f"scan{MEASURE_SCAN_K}"])
             == _record_keys(recs["scan1"]),
             f"ablation_path: the records at scan_k {MEASURE_SCAN_K} differ "
             f"from scan_k 1's")
    for k in ABLATION_KERNELS:
        _require(counts[k] > 0,
                 f"ablation_path: {k} never launched: {counts}")
    return res


# ---------------------------------------------------------------------------
# the profiles and microbenchmarks of tools/

MEASURE_CUT_B = 64              # the tools' cut batch (their scripts': 512)
DETECT_TILES, DETECT_BATCH = 8, 2


def _detect_state(seed: int) -> dict:
    """Seeded fast-profile weights whose masks fill their boxes (the mask
    predictor's bias at +3: untrained masks trace into slivers)."""
    from roadsurf_tpu_torch.models import fast_profile, init_params
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    state = from_jax_params(init_params(fast_profile(post_nms_topk=32),
                                        torch.Generator().manual_seed(seed)))
    state["mask_head"]["predictor"]["b"].fill_(3.0)
    return state


def _kept_engine_check(tmp_dir: str) -> dict:
    """Two ``detect_tiles`` calls at scan_k 4 with other weights: the
    second reuses the first's engine and graph (no capture) and gives a
    fresh engine's records, unlike the first call's."""
    from roadsurf_tpu_torch.io.geotiff import write_geotiff
    from roadsurf_tpu_torch.models import fast_profile
    from roadsurf_tpu_torch.pipeline import detections
    from roadsurf_tpu_torch.utils.graphs import CapturedGraph

    rng = np.random.default_rng(11)
    paths = []
    for i in range(DETECT_TILES):
        paths.append(os.path.join(tmp_dir, f"t{i}.tif"))
        write_geotiff(paths[-1], rng.integers(0, 255, (TILE, TILE, 3),
                                              np.uint8),
                      (0.0, 0.0, float(TILE), float(TILE)))
    bounds = [(0.0, 0.0, float(TILE), float(TILE))] * len(paths)
    cfg = fast_profile(post_nms_topk=32)
    kw = {"batch_size": DETECT_BATCH, "scan_k": 4, "device": "cuda"}
    detections.drop_engines()
    first = detections.detect_tiles(_detect_state(0), cfg, paths, bounds,
                                    **kw)
    captures = CapturedGraph.captures
    second = detections.detect_tiles(_detect_state(1), cfg, paths, bounds,
                                     **kw)
    second_captures = CapturedGraph.captures - captures
    detections.drop_engines()
    fresh = detections.detect_tiles(_detect_state(1), cfg, paths, bounds,
                                    **kw)
    detections.drop_engines()
    res = {"records": [len(first), len(second), len(fresh)],
           "second_call_captures": second_captures,
           "second_equals_fresh": _record_keys(second) == _record_keys(fresh),
           "first_differs": _record_keys(first) != _record_keys(second)}
    _require(second_captures == 0 and res["second_equals_fresh"]
             and res["first_differs"] and len(second) > 0,
             f"detect_tiles' kept engine: {res}")
    return res


def phase_measure_path() -> dict:
    """measure_path: each tool of ``tools/`` that ports a reference
    profile or microbenchmark, through its ``run`` at one step and a cut
    batch, with its checks (the phase's docstring entry, 19b)."""
    import shutil
    import tempfile

    from roadsurf_tpu_torch.engine import TileInferenceEngine
    from roadsurf_tpu_torch.models import fast_profile
    from roadsurf_tpu_torch.models.config import ModelConfig
    from roadsurf_tpu_torch.ops.cuda_build import BUILD_DIR
    from concurrent.futures import ThreadPoolExecutor

    from roadsurf_tpu_torch.ops import cuda_build
    from roadsurf_tpu_torch.tools import (bench_conv_dtypes, bench_int8_gemm,
                                          bench_pooler, bench_pooler_variants,
                                          bench_proposals, bench_training,
                                          profile_heads, profile_proposals,
                                          profile_stages, profile_training)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # the pooler's attribution libraries (its kernel stopped after each
    # phase), built together
    with ThreadPoolExecutor(len(bench_pooler_variants.STAGES)) as ex:
        stage_builds = list(ex.map(lambda n: cuda_build.build(
            "roi_align", (("ROI_ALIGN_STAGE", n),))["seconds"],
            [n for _, n in bench_pooler_variants.STAGES]))
    _reset_counts()
    res: dict = {"phase": "measure_path", "tools": {},
                 "stage_build_s": stage_builds}
    one = {"BENCH_STEPS": "1"}
    for label, env in (("bf16", one), ("int8", dict(one, BENCH_INT8="1"))):
        rows = profile_stages.run(env=env, batch=MEASURE_CUT_B)
        # the FULL row against the engine's output on the same tiles
        cfg = profile_stages.settings(env)["cfg"]
        state = profile_stages.model_state(cfg, dev)
        images = profile_stages.tile_batches(MEASURE_CUT_B, 1, dev)[0]
        with torch.inference_mode():
            full = dict(profile_stages.stages(state, cfg))[
                "+mask_head=FULL"](images)
        eng = TileInferenceEngine(state, cfg, batch_size=MEASURE_CUT_B,
                                  mask_format="logits", device="cuda")
        out = next(iter(eng.run([images.cpu().numpy()])))
        equal = sorted(out) == sorted(full) and all(
            np.array_equal(out[k], full[k].cpu().numpy()) for k in out)
        res["tools"][f"profile_stages_{label}"] = {
            "rows": {r["stage"]: r["ms_per_batch"] for r in rows},
            "full_equals_engine": equal}
        _require(equal and len(rows) == len(profile_stages.STAGE_NAMES),
                 f"measure_path: profile_stages {label}: the FULL row is "
                 f"not the engine's output")
        del eng, state, images, full, out
    env = dict(one)
    res["tools"]["profile_heads"] = [r["ms_per_batch"] for r in
                                     profile_heads.run(env=env,
                                                       batch=MEASURE_CUT_B)]
    res["tools"]["profile_proposals"] = [
        r["ms_per_batch"] for r in profile_proposals.run(
            env=env, batch=MEASURE_CUT_B)]
    res["tools"]["bench_proposals"] = [
        r["ms_per_batch"] for r in bench_proposals.run(
            env=env, batch=MEASURE_CUT_B)]
    train = bench_training.bench_one(ModelConfig(), 256, 8, 1, "256px",
                                     scan_k=4, device="cuda")
    res["tools"]["bench_training"] = train
    _require(np.isfinite(train["loss"]) and 0 < train["mfu"] <= 1,
             f"measure_path: bench_training: {train}")
    rows = profile_training.run(env=env, batch=4)
    res["tools"]["profile_training"] = [r["ms_per_step"] for r in rows]
    _require(all(np.isfinite(r["scalar"]) for r in rows),
             f"measure_path: profile_training: {rows}")
    res["tools"]["bench_pooler"] = bench_pooler.run(
        env={"BENCH_CASES": "R=32", **env}, batch=MEASURE_CUT_B)
    _require(not any("error" in r for r in res["tools"]["bench_pooler"]),
             f"measure_path: bench_pooler: {res['tools']['bench_pooler']}")
    variants = bench_pooler_variants.run(env=env, batch=MEASURE_CUT_B)
    res["tools"]["bench_pooler_variants"] = {
        r["case"]: r.get("event_ms_per_batch") for r in variants}
    _require(all("ms_per_batch" in r for r in variants
                 if r.get("counterpart", True) is not None),
             f"measure_path: bench_pooler_variants: {variants}")
    micro = {"BENCH_KREP": "2", **env}
    res["tools"]["bench_int8_gemm"] = len(bench_int8_gemm.run(
        env=micro, batch=MEASURE_CUT_B))
    res["tools"]["bench_conv_dtypes"] = len(bench_conv_dtypes.run(
        env=micro, batch=MEASURE_CUT_B))
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        res["kept_engine"] = _kept_engine_check(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"] = _read_counts()
    res["seconds"] = time.perf_counter() - t0
    _emit(res)
    for k in ("roi_align", "roi_align_int8", "roi_align_blocked",
              "roi_align_backward", "int8_gemm", "bias_act"):
        _require(res["launches"][k] > 0,
                 f"measure_path: {k} never launched: {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# the reference's benchmark and its one-card entry point

# bench.py's four settings (tools/bench.py at its own batch and k, at
# BENCH_PATH_STEPS timed steps): (cell, knobs, the kernel launches of one
# forward)
BENCH_CELLS = (("fast_int8", {}, {"roi_align_int8": 2}),
               ("fast_bf16", {"BENCH_INT8": "0"},
                {"roi_align": 2, "bias_act": EPILOGUE}),
               ("parity_int8", {"BENCH_PROFILE": "parity"},
                {"roi_align_blocked_int8": 2, "nms": 2}),
               ("parity_bf16", {"BENCH_PROFILE": "parity", "BENCH_INT8": "0"},
                {"roi_align_blocked": 2, "nms": 2, "bias_act": EPILOGUE}))
BENCH_PATH_STEPS = 2
# the reference's entry(): fast_profile() (8 detections, 28x28 masks) on
# 8 tiles, the forward's outputs and their shapes
ENTRY_SHAPES = {"boxes": (8, 8, 4), "scores": (8, 8), "classes": (8, 8),
                "valid": (8, 8), "mask_logits": (8, 8, 28, 28)}


def _bench_cell(label: str, env: dict, per_forward: dict) -> dict:
    """One setting of ``tools/bench.py`` at ``BENCH_PATH_STEPS`` steps: its
    measurement (the warm-up call, which captures the graph, and the
    timed lag-1 steps), with the launches counted over it; then each
    step's batch replayed alone, the first under torch.profiler, whose
    sums must equal the lag-1 scalars bit for bit (the first step's scalar
    is fetched after the second step's copy and replay are enqueued, so a
    scalar read from the graph's static outputs would be the second
    step's) and whose kernel names must count what the counters count."""
    from roadsurf_tpu_torch.tools import bench

    b = bench.Bench(dict(env, BENCH_STEPS=str(BENCH_PATH_STEPS)))
    try:
        _reset_counts()
        plain0 = _plain_convs()
        res = b.measure()
        counts = _read_counts()
        plain = _plain_convs() - plain0
        k = max(b.scan_k, 1)
        # the capture's two eager warm-up forwards, then k forwards a
        # replay: the warm-up call's and each step's
        forwards = (2 + k * (1 + b.steps)) if b.scan_k > 1 else 1 + b.steps
        want = {c: per_forward.get(c, 0) * forwards for c in counts}
        _require(counts == want and plain == 0, f"bench_path {label}: "
                 f"launches {counts}, expected {want}; {plain} plain convs")
        alone = []
        before = _read_counts()
        kernels, wall = _device_kernels(
            lambda: alone.append(b.alone(b.batches[0])))
        after = _read_counts()
        alone += [b.alone(x) for x in b.batches[1:]]
    finally:
        b.close()
    seen = _profiled_launches(kernels)
    counted = {c: after[c] - before[c] for c in after if after[c] != before[c]}
    pooler = next(c for c in per_forward if c.startswith("roi_align"))
    _require(counted == {c: n * k for c, n in per_forward.items()}
             and seen["pooler"] == counted[pooler]
             and seen["nms"] == counted.get("nms", 0),
             f"bench_path {label}: the profiler saw {seen}, the counters "
             f"{counted}, over one replay of {k} forwards")
    _require(alone == res["scalars"] and all(np.isfinite(alone)),
             f"bench_path {label}: lag-1 scalars {res['scalars']}, each "
             f"batch alone {alone}")
    # distinct sums, or the gate above could not tell a step's scores
    # from the next step's
    _require(len(set(alone)) == len(alone),
             f"bench_path {label}: the batches' sums {alone} are not "
             f"distinct")
    line = res.pop("line")
    out = {"phase": "bench_path", "cell": label, **res, "line": line,
           "alone_scalars": alone, "launches": counts,
           "profiled_launches": seen, "profiled": _split(kernels, wall)}
    _emit(out)
    return out


def _entry_check() -> dict:
    """``roadsurf_tpu_torch.entry.entry()``'s forward on its own
    arguments: the reference's output keys and shapes, finite, K1 twice,
    K6 EPILOGUE times."""
    from roadsurf_tpu_torch.entry import entry

    fn, (state, images) = entry()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn(state, images)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    finite = all(bool(torch.isfinite(out[k].float()).all())
                 for k in ("boxes", "scores", "mask_logits"))
    _require(shapes == ENTRY_SHAPES and finite
             and out["valid"].dtype == torch.bool,
             f"bench_path entry: shapes {shapes}, finite {finite}")
    want = {c: {"roi_align": 2, "bias_act": EPILOGUE}.get(c, 0)
            for c in counts}
    _require(counts == want, f"bench_path entry: launches {counts}")
    return {"shapes": {k: list(v) for k, v in shapes.items()},
            "valid": int(out["valid"].sum()), "seconds": seconds,
            "launches": counts}


def phase_bench_path() -> dict:
    """bench_path: ``tools/bench.py``, the reference's ``bench.py``, at
    each of its four settings, and ``entry()``'s forward (the phase's
    docstring entry, 19c)."""
    t0 = time.perf_counter()
    cells = {label: _bench_cell(label, env, per_forward)
             for label, env, per_forward in BENCH_CELLS}
    entry = _entry_check()
    res = {"phase": "bench_path",
           "cells": {k: {f: v[f] for f in (
               "tiles_per_s", "host_s", "event_ms_per_step", "capture_s",
               "pool_bytes", "copy_ms", "peak_allocated_bytes")}
               for k, v in cells.items()},
           "entry": entry,
           "launches": _sum_counts(*(c["launches"] for c in cells.values()),
                                   entry["launches"]),
           "seconds": time.perf_counter() - t0}
    _emit(res)
    return res


# ---------------------------------------------------------------------------
# tif2cog

COG_SIDE, COG_RUN_SIDE, COG_RUN_IMAGES = 10000, 2000, 3


def _lv95_image(rng, side: int, px: float) -> object:
    """A SWISSIMAGE-RS-like EPSG:2056 raster: ``side``² pixels of ``px`` m,
    4 bands of uint16 (NIR, R, G, B) over 1..65534 with a nodata (0)
    border of 20 rows and 30 columns."""
    from roadsurf_tpu_torch.io.geotiff import Raster

    data = rng.integers(1, 65535, (side, side, 4), dtype=np.uint16)
    data[:20] = 0
    data[-20:] = 0
    data[:, :30] = 0
    data[:, -30:] = 0
    x0 = 2600000.0 + float(rng.integers(0, 50)) * 1000.0
    y0 = 1200000.0 - float(rng.integers(0, 50)) * 1000.0
    return Raster(data=data, origin=(x0, y0), pixel_size=(px, px),
                  epsg=2056, nodata=0)


def _tiff_levels(path: str) -> list:
    """(width, height) of every IFD of a little-endian TIFF."""
    with open(path, "rb") as f:
        buf = f.read()
    off = struct.unpack_from("<I", buf, 4)[0]
    levels = []
    while off:
        n = struct.unpack_from("<H", buf, off)[0]
        tags = {}
        for i in range(n):
            tag, typ, _, val = struct.unpack_from("<HHII", buf,
                                                  off + 2 + 12 * i)
            tags[tag] = val & 0xFFFF if typ == 3 else val
        levels.append((tags[256], tags[257]))
        off = struct.unpack_from("<I", buf, off + 2 + 12 * n)[0]
    return levels


def phase_cog_path() -> dict:
    """cog_path: the tif2cog device stages. (a) One SWISSIMAGE-RS-sized
    image (1 km² at 0.1 m: COG_SIDE² × 4 uint16, 800 MB, EPSG:2056, a
    nodata border): the host inverse map in row chunks, the device
    gather, equal to a numpy gather of the same indices; ``band_stats``
    min/max equal to numpy's, mean/std within rtol 1e-5 of float64
    numpy; ``scale_to_byte`` equal to its plain CPU version; each stage
    timed apart. (b) ``Tif2Cog.run`` over a ``LocalStore`` under
    ``_build/`` on COG_RUN_IMAGES images of COG_RUN_SIDE²: steps 1-3, a
    rerun that skips every image, and the COGs read back in EPSG:3857
    with their overviews."""
    import tempfile

    from roadsurf_tpu_torch.io.geotiff import read_geotiff, write_geotiff
    from roadsurf_tpu_torch.io.objstore import LocalStore
    from roadsurf_tpu_torch.ops.cuda_build import BUILD_DIR
    from roadsurf_tpu_torch.pipeline import cog_pipeline as cp

    rng = np.random.default_rng(9)
    r = _lv95_image(rng, COG_SIDE, 0.1)
    h, w, c = r.data.shape
    dev = torch.device("cuda")
    grid = cp.dst_grid(r, 3857)
    ow, oh = grid[4], grid[5]
    t0 = time.perf_counter()
    chunks = [cp.inverse_map(r, grid, 3857, r0, min(r0 + cp.CHUNK_ROWS, oh))
              for r0 in range(0, oh, cp.CHUNK_ROWS)]
    map_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src = cp._upload(r.data, dev).reshape(h * w, c)
    idx = [torch.from_numpy(i).to(dev) for i, _ in chunks]
    ok = [torch.from_numpy(v).to(dev) for _, v in chunks]
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    fill = torch.zeros((), dtype=src.dtype, device=dev)
    out = torch.empty((oh * ow, c), dtype=src.dtype, device=dev)

    def gather_all():
        row = 0
        for i, v in zip(idx, ok):
            out[row:row + len(i)] = cp.gather(src, i, v, fill)
            row += len(i)

    gather_ms = _time_ms(gather_all, 3, warmup=1)
    warped = out.cpu().numpy().view(np.uint16).reshape(oh, ow, c)
    flat_idx = np.concatenate([i for i, _ in chunks])
    flat_ok = np.concatenate([v for _, v in chunks])
    want = np.where(flat_ok[:, None], r.data.reshape(h * w, c)[flat_idx],
                    0).reshape(oh, ow, c)
    _require(np.array_equal(warped, want),
             "cog_path: the device gather differs from numpy's")
    del src, idx, ok, out, want, flat_idx

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = cp.band_stats(warped, nodata=0.0, device=dev)
    stats_s = time.perf_counter() - t0
    worst = 0.0
    for b in range(c):
        x = warped[:, :, b]
        v = x[x != 0].astype(np.float64)
        s = stats[str(b + 1)]
        _require((s["min"], s["max"]) == (float(v.min()), float(v.max())),
                 f"cog_path: band {b + 1} min/max {s} vs numpy")
        for k, ref in (("mean", v.mean()), ("stddev", v.std())):
            err = abs(s[k] - ref) / abs(ref)
            worst = max(worst, err)
            _require(err <= 1e-5, f"cog_path: band {b + 1} {k} {s[k]} vs "
                                  f"float64 {ref}")
        del v
    bounds = [(2000.0, 52000.0), (1000.0, 60000.0), (1000.0, 60000.0),
              (1000.0, 60000.0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    byte = cp.scale_to_byte(warped, bounds, device=dev)
    scale_s = time.perf_counter() - t0
    _require(np.array_equal(byte, cp.scale_to_byte(warped, bounds,
                                                   device="cpu")),
             "cog_path: scale_to_byte on the card differs from the CPU's")
    del byte, warped
    big = {"image": [h, w, c], "bytes": r.data.nbytes,
           "dst": [oh, ow], "valid_share": float(np.mean(
               np.concatenate([v for _, v in chunks]))),
           "inverse_map_host_s": map_s, "h2d_s": h2d_s,
           "gather_ms": gather_ms, "band_stats_s": stats_s,
           "band_stats_worst_rel_err": worst, "scale_to_byte_s": scale_s}
    del chunks, r

    # (b) the pipeline over a LocalStore
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as wd:
        store = LocalStore(os.path.join(wd, "store"))
        for i in range(COG_RUN_IMAGES):
            im = _lv95_image(rng, COG_RUN_SIDE, 0.5)
            p = os.path.join(wd, f"src{i}.tif")
            write_geotiff(p, im.data, im.bounds, epsg=2056, nodata=0)
            store.upload(p, f"in/swissimage_{i}.tif")
        pipe = cp.Tif2Cog(store, "in", "tif", "cog",
                          workdir=os.path.join(wd, "work"), device=dev)
        first = pipe.run()
        again = pipe.run()
        n = COG_RUN_IMAGES
        _require(first["done"] == {"step1": n, "step2": n, "step3": n},
                 f"cog_path: steps {first['done']}")
        _require(again["done"] == {"step1": 0, "step2": 0, "step3": 0},
                 f"cog_path: rerun {again['done']}")
        levels = []
        for i in range(n):
            for prefix, dtype in (("tif", np.uint16), ("cog", np.uint8)):
                path = store.open_path(f"{prefix}/swissimage_{i}.tif")
                back = read_geotiff(path)
                _require(back.epsg == 3857 and back.data.dtype == dtype
                         and back.data.shape == (COG_RUN_SIDE,
                                                 COG_RUN_SIDE, 4),
                         f"cog_path: {path} reads back as {back.epsg}, "
                         f"{back.data.dtype}, {back.data.shape}")
                lv = _tiff_levels(path)
                _require(lv[1:] == [((COG_RUN_SIDE + f - 1) // f,) * 2
                                    for f in (2, 4, 8, 16, 32, 64, 128, 256)],
                         f"cog_path: {path} overviews {lv}")
                levels.append(len(lv))
    res = {"phase": "cog_path", "swissimage_rs_1km2": big,
           "pipeline": {"images": n, "side": COG_RUN_SIDE,
                        "seconds": first["seconds"],
                        "summary": first["summary"],
                        "ifds_per_file": sorted(set(levels))}}
    _emit(res)
    return res


DEM_TILE_M, DEM_PX = 1000.0, 2.0    # swissALTI3D's 1 km² tiles at 2 m
PCA_TOL = 1e-9                      # card against CPU, of max|value|
PCA_AT_SCALE_ROWS = 3_700_000       # the pixel rows of the whole 9 km²


def _pca_agreement(frame, feats, timed: dict) -> dict:
    """``calculate_pca`` of one frame on the card and with device="cpu":
    the largest difference of the components, explained variances and
    coordinates over each one's max|value|, and both times."""
    from roadsurf_tpu_torch.stats import calculate_pca

    t0 = time.perf_counter()
    gpu, gc = calculate_pca(frame, feats, "road_type", None, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu, cc = calculate_pca(frame, feats, "road_type", None, device="cpu")
    t2 = time.perf_counter()
    timed["cuda_s"] = timed.get("cuda_s", 0.0) + t1 - t0
    timed["cpu_s"] = timed.get("cpu_s", 0.0) + t2 - t1

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    ev = cpu.explained_variance_
    k = int((ev > 1e-10 * ev[0]).sum())    # the null space's any basis
    return {"rows": len(frame), "features": len(feats), "solver": gpu.solver,
            "components": rel(gpu.components_[:k], cpu.components_[:k]),
            "variance": rel(gpu.explained_variance_, ev),
            "coordinates": rel(gc, cc), "determined": k}


def _dem_tiles(rng) -> dict:
    """Nine 1 km² DEM tiles at 2 m over the scene (uint16 metres: the
    GeoTIFF codec takes 8- and 16-bit unsigned samples; a slope, hills and
    noise), as {url: TIFF bytes} of a local tile service."""
    import tempfile

    from roadsurf_tpu_torch.io import write_geotiff

    n = int(DEM_TILE_M / DEM_PX)
    served = {}
    with tempfile.TemporaryDirectory() as d:
        for i in range(3):
            for j in range(3):
                x0 = SCENE_X0 + i * DEM_TILE_M
                y0 = SCENE_Y0 + j * DEM_TILE_M
                xs = x0 + (np.arange(n) + 0.5) * DEM_PX
                ys = y0 + DEM_TILE_M - (np.arange(n) + 0.5) * DEM_PX
                gx, gy = np.meshgrid(xs - SCENE_X0, ys - SCENE_Y0)
                z = (450 + 0.02 * gx + 0.01 * gy
                     + 30 * np.sin(gx / 400) * np.cos(gy / 300)
                     + rng.normal(0, 0.5, gx.shape))
                name = f"swissalti3d_2019_{2600 + i}-{1200 + j}_2_2056.tif"
                p = os.path.join(d, name)
                write_geotiff(p, z.round().astype(np.uint16),
                              (x0, y0, x0 + DEM_TILE_M, y0 + DEM_TILE_M),
                              epsg=2056)
                with open(p, "rb") as f:
                    served[f"https://data.geo.admin.ch/ch.swisstopo."
                           f"swissalti3d/{name}"] = f.read()
    return served


def phase_stats_path() -> dict:
    """The statistical branch on the card's host, its PCAs on the card.
    ``write_scene``'s GRID x GRID jittered road grid in 9 km²; then
    ``stats_chain``: config/config_stats.yaml's blocks, ``pipeline.
    stats_prep`` (both tasks), ``pipeline.label_prep`` (the tiles over
    ``roads_polygons_stats.shp``), ``pipeline.tilesets`` (4-band tiles
    from ``BandsOpener``; the YAML's debug cap of 100 tiles) and
    ``pipeline.stats_analysis`` at the YAML's ``param`` with
    ``do_ks_test`` on, the PCAs on ``cuda`` (figures off when matplotlib is
    missing: the PCAs' tables alone); ``assess --statistics`` on the
    tileset; the DEM chain (nine 1 km² DEM tiles at 2 m from a local
    opener through ``tiles.rasters.run``: download, mosaic, zonal
    statistics of the roads); the sandbox tools (``limit_used_tiles``,
    ``correct_gt``, ``add_tile_mask`` on 20 tiles) and ``upload.run`` into
    a ``LocalStore``, twice. Checks: no two road polygons overlap by more
    than 1 m²; the restricted AOI agrees with ``aoi_oracle`` at 1 m within
    1% of its area, with at least one hole for each field no forest
    reaches; the pixel rows equal the masks' pixel counts; each PCA on the
    card equals its CPU run within PCA_TOL·max|value| (also on the pixel
    frame repeated to PCA_AT_SCALE_ROWS rows, timed both ways); the DEM
    statistics equal numpy's over the same masks; the limiter keeps the
    tiles that touch the GT and not the other labels; the corrections
    land; each tile mask is 255 exactly on the fill of the roads; each
    road the analysis repairs with buffer(0) (invalid once reprojected)
    covers the points its own fill covers; the
    second upload skips every file; every file the YAML promises is
    written (and its figures decode, where there are figures)."""
    import importlib.util
    import tempfile

    import pandas as pd
    import yaml

    from roadsurf_tpu_torch.geom import GeoDataFrame
    from roadsurf_tpu_torch.io import read_excel, read_file, read_geotiff
    from roadsurf_tpu_torch.io.objstore import LocalStore
    from roadsurf_tpu_torch.ops.cuda_build import BUILD_DIR
    from roadsurf_tpu_torch.pipeline import (assess, label_prep, sandbox,
                                             stats_analysis, stats_prep,
                                             tilesets, upload)
    from roadsurf_tpu_torch.stats.pixels import _geometry_mask
    from roadsurf_tpu_torch.tiles import WebMercatorQuad, parse_tile_id
    from roadsurf_tpu_torch.tiles import rasters

    from importlib import metadata

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    libraries = {}
    for dist in ("matplotlib", "scipy", "pillow", "scikit-learn", "pandas"):
        try:
            libraries[dist] = metadata.version(dist)
        except metadata.PackageNotFoundError:
            libraries[dist] = None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = {"phase": "stats_path", "matplotlib": has_mpl,
           "libraries": libraries,
           "scene": {"grid": GRID, "aoi_km2": (SCENE_SIDE / 1e3) ** 2},
           "reduced": {"aoi_km2": "9 of swissTLM3D's ~840 (time)",
                       "tiles": "the YAML's debug cap (100)",
                       "figures": "drawn" if has_mpl else
                       "none: no matplotlib on this machine"}}
    s = {}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        t0 = time.perf_counter()
        data = write_scene(root)
        s["scene"] = time.perf_counter() - t0
        out = os.path.join(root, "outputs")
        os.makedirs(os.path.join(root, "tmp"))
        calls, an_s = [], {}
        procedure = stats_analysis.pca_procedure

        def logged(dataset, features, *a, **kw):
            calls.append((dataset.copy(), list(features)))
            return procedure(dataset, features, *a, **kw)

        stats_analysis.pca_procedure = logged
        try:
            chain_s, opener = stats_chain(
                (stats_prep, label_prep, tilesets, stats_analysis), data,
                out, os.path.join(root, "tmp"), ks=True, figures=has_mpl,
                analysis_kw={"device": "cuda", "figures": has_mpl,
                             "timings": an_s})
        finally:
            stats_analysis.pca_procedure = procedure
        s.update(chain_s)
        s["stats_analysis_stages"] = an_s
        shp = os.path.join(out, "shapefiles_gpkg")
        polys = read_file(os.path.join(shp, "roads_polygons_stats.shp"))

        # the road polygons: no overlap
        geoms = list(polys.geometry.values)
        bounds = np.array([g.bounds for g in geoms])
        worst = 0.0
        for i in range(len(geoms)):
            near = np.flatnonzero(
                (bounds[i + 1:, 0] <= bounds[i, 2])
                & (bounds[i + 1:, 2] >= bounds[i, 0])
                & (bounds[i + 1:, 1] <= bounds[i, 3])
                & (bounds[i + 1:, 3] >= bounds[i, 1])) + i + 1
            for j in near:
                worst = max(worst, (geoms[i] & geoms[j]).area)
        _require(worst <= 1.0, f"two road polygons overlap by {worst} m²")

        # the restricted AOI against the oracle
        roads = read_file(os.path.join(data, "swissTLM3D",
                                       "roads_lines.shp"))
        forests = read_file(os.path.join(data, "swissTLM3D", "forests.shp"))
        params = read_excel(os.path.join(data, "roads_parameters.xlsx"))
        _, in_aoi = stats_prep.determine_road_surfaces_stats(
            roads, forests, params,
            read_file(os.path.join(data, "AOI", "aoi.shp")))
        oracle = aoi_oracle(in_aoi.geometry.values, forests.geometry.values,
                            (params["Width"].max() + 1) / 2)
        raoi = read_file(os.path.join(shp, "restricted_AOI.shp"))
        aoi = aoi_agreement(raoi.geometry.values, oracle)
        _require(aoi["mismatch_m2"] <= 0.01 * aoi["oracle_m2"]
                 and aoi["holes"] >= aoi["fields_free"] > 0,
                 f"restricted_AOI.shp against the oracle: {aoi}")

        # the analysis's buffer(0) repair of the roads its reprojection to
        # EPSG:3857 leaves invalid, against the point oracle
        from roadsurf_tpu_torch.geom import _native

        def inside(g, pts):
            parts = g.geoms if g.geom_type == "MultiPolygon" else [g]
            return _native.points_in_polyset(pts, _native.pack(
                [[q.exterior_coords, *q.interiors_coords] for q in parts]))

        p3857 = polys.to_crs(epsg=3857)
        rng = np.random.default_rng(17)
        repaired = 0
        for g, ok in zip(p3857.geometry.values, p3857.is_valid):
            if ok:
                continue
            pts = rng.uniform(g.bounds[:2], g.bounds[2:], (200000, 2))
            fixed = g.buffer(0)
            _require(fixed.is_valid and np.array_equal(
                inside(fixed, pts), inside(g, pts)),
                "a reprojected road's buffer(0) differs from its fill")
            repaired += 1

        # the pixel rows against the masks' pixel counts
        od = os.path.join(out, "obj_detector")
        tiles = read_file(os.path.join(out, "json_inputs",
                                       "tiles_aoi.geojson")).to_crs(
            epsg=3857)
        on_disk = {}
        for tid in tiles["id"]:
            t = parse_tile_id(tid)
            p = os.path.join(od, "all-images",
                             WebMercatorQuad.tile_filename(t))
            if os.path.exists(p):
                on_disk[tid] = read_geotiff(p)
        tb = {tid: WebMercatorQuad.xy_bounds(parse_tile_id(tid))
              for tid in on_disk}
        masked = 0
        for g in p3857.geometry.values:
            x0, y0, x1, y1 = g.bounds
            for tid, r in on_disk.items():
                w, so, e, n = tb[tid]
                if x0 <= e and x1 >= w and y0 <= n and y1 >= so:
                    masked += int(_geometry_mask(g, r).sum())
        pixels, feats = calls[0]
        _require(len(pixels) == masked > 0,
                 f"{len(pixels)} pixel rows, {masked} masked pixels")

        # every PCA on the card against the CPU, and at scale
        pca_t = {}
        agree = [_pca_agreement(f, c, pca_t) for f, c in calls]
        big = pd.concat([pixels] * int(np.ceil(PCA_AT_SCALE_ROWS
                                               / len(pixels))),
                        ignore_index=True)
        scale_t = {}
        at_scale = _pca_agreement(big, feats, scale_t)
        del big
        _require(all(max(a["components"], a["variance"], a["coordinates"])
                     <= PCA_TOL for a in agree + [at_scale]),
                 f"the card's PCA differs from the CPU's: {agree}, "
                 f"{at_scale}")

        # every file the YAML promises
        with open(os.path.join(ROOT, "config", "config_stats.yaml")) as f:
            scfg = yaml.safe_load(f)
        final = os.path.join(out, "final")
        want = [os.path.join(out, "tables", "stats_roads.csv")] + [
            os.path.join(final, "tables", n) for n in (
                "statistics_roads_by_type.csv", "ks_test.csv")]
        for prefix in ["PCA_pixels_"] + [f"PCA_stats_band_{b}_" for b in
                                         stats_analysis.BANDS_STR]:
            want += [os.path.join(final, "tables", prefix + n) for n in (
                "values.csv", "loading_matrix.csv", "corr_matrix.csv")]
        figures = []
        if has_mpl and scfg["statistical_analysis.py"]["param"][
                "make_boxplots"]:
            figures += [os.path.join(final, "images", n) for n in (
                "boxplot_pixel_in_bands.webp",
                "boxplot_pixel_by_VgNIR_BI.webp")]
        if has_mpl:
            figures += [os.path.join(final, "images",
                                     "PCA_pixels_PC_to_keep_evplot.jpg"),
                        os.path.join(final, "images",
                                     "PCA_pixels_PC12_features.webp")]
        missing = [p for p in want + figures if not os.path.exists(p)]
        _require(not missing, f"the analysis did not write {missing}")
        if figures:
            from PIL import Image

            for p in figures:
                with Image.open(p) as im:
                    im.load()
        ks = pd.read_csv(os.path.join(final, "tables", "ks_test.csv"))
        _require(len(ks) > 0 and ks["ks_p_red"].between(0, 1).all(),
                 "ks_test.csv")

        # assess --statistics on the tileset (calculate_statistics.py)
        t0 = time.perf_counter()
        block = os.path.join(root, "assess.yaml")
        with open(block, "w") as f:
            yaml.safe_dump({"calculate_statistics.py": {
                "working_folder": od, "tiles": "split_aoi_tiles.geojson"}},
                f)
        _require(assess.main([block, "--statistics"]) == 0, "assess")
        with open(os.path.join(od, "img_statistics.json")) as f:
            assess_stats = json.load(f)
        _require(assess_stats["oth"]["n_pixels"] == TILE * TILE
                 * opener.served and len(assess_stats["oth"]["mean"]) == 4,
                 f"img_statistics.json: {assess_stats}")
        s["assess"] = time.perf_counter() - t0

        # the DEM chain
        dem = os.path.join(root, "DEM")
        os.makedirs(dem)
        served = _dem_tiles(np.random.default_rng(12))
        with open(os.path.join(dem, "urls.csv"), "w") as f:
            f.write("\n".join(served) + "\n")
        dem_s = {}
        rasters.run(dem, out, out, "urls.csv",
                    "shapefiles_gpkg/roads_polygons_stats.shp",
                    generate_mosaic=True, opener=served.__getitem__,
                    timings=dem_s)
        s["dem"] = dem_s
        zs = read_file(os.path.join(shp, "roads_dem_zs.shp"))
        mosaic = read_geotiff(os.path.join(out, "DEM", "DEM_aoi.tif"))
        _require(mosaic.data.shape[:2] == (1500, 1500),
                 f"DEM mosaic {mosaic.data.shape}")
        bad = 0
        for g, row in zip(polys.geometry.values, zs.itertuples()):
            v = mosaic.data[:, :, 0][_geometry_mask(g, mosaic).astype(
                bool)].astype(np.float64)
            if len(v):
                bad += not (row.min == v.min() and row.max == v.max()
                            and np.isclose(row.mean, v.mean(), rtol=1e-12)
                            and row.median == np.median(v)
                            and np.isclose(row.std, v.std(), rtol=1e-9))
            else:
                bad += not pd.isna(row.mean)
        _require(bad == 0, f"{bad} roads' DEM statistics differ from "
                 "numpy's")

        # the sandbox tools
        t0 = time.perf_counter()
        pol4326 = polys.to_crs(epsg=4326)
        gt = GeoDataFrame(pol4326[pol4326["OBJECTID"] % 2 == 0].copy(),
                          crs=pol4326.crs)
        oth = GeoDataFrame(pol4326[pol4326["OBJECTID"] % 2 == 1].copy(),
                           crs=pol4326.crs)
        tiles4326 = read_file(os.path.join(out, "json_inputs",
                                           "tiles_aoi.geojson"))
        kept = sandbox.limit_used_tiles(tiles4326, gt, oth, "trn, tst, val")
        want_ids = [tid for tid, tg in zip(tiles4326["id"],
                                           tiles4326.geometry.values)
                    if any(tg.intersects(g) for g in gt.geometry.values)
                    and not any(tg.intersects(g)
                                for g in oth.geometry.values)]
        _require(sorted(kept["id"]) == sorted(want_ids),
                 "limit_used_tiles kept other tiles than the brute force")
        pick = rng.choice(len(polys), 40, replace=False)
        verified = rng.choice([100, 200, 999997, 12345], 40)
        corrections = GeoDataFrame(
            {"OBJECTID": polys["OBJECTID"].values[pick],
             "Belag_veri": verified,
             "geometry": [polys.geometry.values[k] for k in pick]},
            crs=polys.crs)
        fixed = sandbox.correct_gt(polys, corrections)
        expect = dict(zip(polys["OBJECTID"], polys["BELAGSART"]))
        expect.update({o: int(v) for o, v in zip(
            corrections["OBJECTID"], verified) if v != 12345})
        _require(list(fixed["BELAGSART"]) == [expect[o] for o in
                                              fixed["OBJECTID"]],
                 "correct_gt")
        mask_root = os.path.join(root, "masks")
        split = read_file(os.path.join(od, "split_aoi_tiles.geojson"))
        sub = GeoDataFrame(split.iloc[:20].copy(), crs=split.crs)
        for tid, ds in zip(sub["id"], sub["dataset"]):
            fn = WebMercatorQuad.tile_filename(parse_tile_id(tid))
            os.makedirs(os.path.join(mask_root, f"{ds}-images"),
                        exist_ok=True)
            src = os.path.join(od, f"{ds}-images", fn)
            if os.path.exists(src):
                with open(src, "rb") as fa, open(os.path.join(
                        mask_root, f"{ds}-images", fn), "wb") as fb:
                    fb.write(fa.read())
        mstats = sandbox.add_tile_mask(p3857, sub.to_crs(epsg=3857),
                                       mask_root)
        mask_px = mask_bad = 0
        for tid, ds in zip(sub["id"], sub["dataset"]):
            fn = WebMercatorQuad.tile_filename(parse_tile_id(tid))
            p = os.path.join(mask_root, f"{ds}-images", fn)
            if not os.path.exists(p):
                continue
            r = read_geotiff(p)
            road = np.zeros(r.data.shape[:2], bool)
            for g in p3857.geometry.values:
                road |= _geometry_mask(g, r).astype(bool)
            mask_bad += int(((r.data[:, :, 4] == 255) != road).sum())
            mask_px += road.size
        _require(len(mstats) > 0 and mask_bad <= 0.001 * mask_px,
                 f"tile masks: {mask_bad} of {mask_px} pixels off the "
                 "roads' fill")
        s["sandbox"] = time.perf_counter() - t0

        # upload, then again
        t0 = time.perf_counter()
        with open(os.path.join(ROOT, "config",
                               "config_preprocessing.yaml")) as f:
            up = yaml.safe_load(f)["RS_images_to_S3.py"]
        up.update(datapath=os.path.join(od, "all-images", "*"),
                  local_store_root=os.path.join(root, "store"))
        first = upload.run(up)
        second = upload.run(up)
        store = LocalStore(os.path.join(root, "store"))
        _require(len(first) == len(os.listdir(os.path.join(
            od, "all-images"))) > 0 and second == []
                 and all(store.exists(k) for k in first),
                 f"upload: {len(first)} then {len(second)}")
        s["upload"] = time.perf_counter() - t0

    res.update({
        "s": s, "pixel_rows": len(pixels), "features": len(feats),
        "pca": {"cuda_s": pca_t["cuda_s"], "cpu_s": pca_t["cpu_s"],
                "per_call": agree},
        "pca_at_scale": {**at_scale, **scale_t},
        "roads": len(polys), "worst_overlap_m2": worst,
        "roads_repaired_by_buffer0": repaired,
        "restricted_aoi": aoi, "tiles_served": opener.served,
        "roads_with_ks": len(ks), "dem_roads": len(zs),
        "limit_used_tiles": {"kept": len(kept), "of": len(tiles4326)},
        "tile_masks": {"tiles": len(mstats), "pixels_off": mask_bad},
        "uploaded": len(first), "assess_statistics": assess_stats})
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
    from roadsurf_tpu_torch.geom.table import GeoDataFrame
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
            plain0 = _plain_convs()
            t0 = time.perf_counter()
            files = detections.run(cfg, batch_size=PB, stats=stats)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = _read_counts()
            plain = _plain_convs() - plain0
        finally:
            detections.merge_params = merge
        _require(merges == [[]], f"host_stage: merge skipped {merges}")
        n_batches = -(-HOST_TILES // PB)
        expect = {"roi_align_blocked": 2, "nms": 2, "bias_act": EPILOGUE}
        want = {k: expect.get(k, 0) * n_batches for k in launches}
        _require(launches == want and plain == 0, f"host_stage: launches "
                 f"{launches}, expected {want}; {plain} plain convs")
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
        ref = GeoDataFrame({"geometry": [r["geometry"] for r in direct],
                            "score": [r["score"] for r in direct],
                            "det_class": [r["det_class"] for r in direct]},
                           crs="EPSG:3857").to_crs(epsg=4326)
        got = rows[:len(ref)]
        same = len(ref) > 0 and all(
            g[40:] == wkb.dumps(p) and sc == float(s_) and c == int(c_)
            for (g, sc, c), p, s_, c_ in zip(got, ref.geometry.values,
                                             ref["score"], ref["det_class"]))
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
# stage, K3 on those and the dense path, K4 on none, K6 (the conv
# epilogue) on every bf16 path
KERNELS = {
    "roi_align": ("roi_align.cu", "roi_align_pallas.py:638", "roi_align"),
    "roi_align_int8": ("roi_align.cu", "roi_align_pallas.py:638",
                       "roi_align_int8"),
    "roi_align_blocked": ("roi_align_blocked.cu", "roi_align_pallas.py:471",
                          "roi_align_blocked"),
    "roi_align_blocked_int8": ("roi_align_blocked.cu",
                               "roi_align_pallas.py:471",
                               "roi_align_blocked_int8"),
    "roi_align_f32": ("roi_align.cu", "roi_align_pallas.py:638",
                      "roi_align_f32"),
    "roi_align_blocked_f32": ("roi_align_blocked.cu",
                              "roi_align_pallas.py:471",
                              "roi_align_blocked_f32"),
    "nms": ("nms.cu", "nms_pallas.py:59", "nms"),
    "int8_gemm": ("int8_gemm.cu", "int8_gemm.py:79", "int8_gemm"),
    # no Pallas kernel: the reference takes this gradient from XLA's
    # autodiff of its separable pooler
    "roi_align_backward": ("roi_align_backward.cu", "roi_align.py:318",
                           "roi_align_backward"),
    "roi_align_backward_f32": ("roi_align_backward.cu", "roi_align.py:318",
                               "roi_align_backward_f32"),
    # no TPU kernel: XLA fuses the reference's bias adds, residual sums
    # and ReLUs into its convolutions
    "bias_act": ("bias_act.cu", None, "bias_act"),
    # no TPU kernel: the JAX package has no ViT
    "rel_attention": ("rel_attention.cu", None, "rel_attention"),
    # no TPU kernel: the JAX package has no ViT and no LayerNorm
    "layer_norm": ("layer_norm.cu", None, "layer_norm"),
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
    cases = {"roi_align": phase_kernels_k1(),
             "roi_align_int8": phase_kernels_k1("int8"),
             "roi_align_f32": phase_kernels_k1("f32"),
             "roi_align_blocked": phase_kernels_k2(),
             "roi_align_blocked_int8": phase_kernels_k2("int8"),
             "roi_align_blocked_f32": phase_kernels_k2("f32"),
             # K3's error is the count of keep flags unlike the plain
             # version's
             "nms": [dict(c, max_abs_err=c["mismatches"])
                     for c in phase_kernels_k3()],
             "int8_gemm": phase_kernels_k4(),
             "roi_align_backward": phase_kernels_k5(),
             "roi_align_backward_f32": phase_kernels_k5(f32=True),
             "bias_act": phase_kernels_k6()}
    cases["rel_attention"], vitdet_forward = phase_kernels_k7()
    cases["layer_norm"] = phase_kernels_k8()
    phase_kernels_k1_p5()
    runs = {"vitdet_forward": vitdet_forward}
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
    from roadsurf_tpu_torch.pipeline.detections import drop_engines

    drop_engines()
    torch.cuda.empty_cache()
    runs["train_path"] = phase_train_path()
    torch.cuda.empty_cache()
    runs["tileset_path"] = phase_tileset_path()
    torch.cuda.empty_cache()
    runs["dp_train"] = phase_dp_train()
    runs["dp_train_run"] = phase_dp_train_run(runs["train_path"])
    torch.cuda.empty_cache()
    runs["dp_infer"] = phase_dp_infer()
    torch.cuda.empty_cache()
    runs["scan_path"] = phase_scan_path()
    torch.cuda.empty_cache()
    runs["measure_path"] = phase_measure_path()
    torch.cuda.empty_cache()
    runs["bench_path"] = phase_bench_path()
    torch.cuda.empty_cache()
    runs["f32_forward"] = phase_f32_forward()
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    from roadsurf_tpu_torch.ops.cuda_build import BUILD_DIR

    wd = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        runs["quality_path"] = phase_quality_path(wd)
        torch.cuda.empty_cache()
        runs["ablation_path"] = phase_ablation_path(wd)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    drop_engines()
    torch.cuda.empty_cache()
    phase_cog_path()
    phase_stats_path()

    # the times are one forward's calls at the main paths' shapes: both
    # poolers (K2 at its adaptive sampling), the RPN's and the class NMS
    # (K3); K4's are its raw GEMMs at the int8 stack's 1x1 and box FC1
    # shapes; K5's one training step's, box and mask poolers at B=8; K6's
    # the parity forward's 77 calls; K7's the 12 of a ViTDet-B forward at
    # B=16, K8's its 41
    _emit({"kernels": [
        _record(name, "roadsurf_tpu_torch/csrc/" + src,
                "roadsurf_tpu/ops/" + tpu if tpu else None,
                {p: r["launches"][count] for p, r in runs.items()
                 if r["launches"][count]},
                cases[name], "max_abs_err",
                "case" if name in ("nms", "int8_gemm", "bias_act",
                                   "rel_attention", "layer_norm")
                else "pooler")
        for name, (src, tpu, count) in KERNELS.items()]})
    print(smi)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
