#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order, one JSON line each; any failure raises and the script
exits non-zero:

1. ``build``: nvcc builds every kernel of the port from ``csrc/`` (one
   process per source, started together).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the main path's shapes (B=64, C=256, P2..P4 at 256 px tiles; box
   pooler R=32 P=7, mask pooler R=8 P=14) and on an edge batch; its time,
   the plain version's time and the least time the card could take.
3. ``main_path``: the fast profile (R50-FPN at full width, bf16, random
   weights from a seed) through ``TileInferenceEngine.run`` over batches of
   64 random 256 px tiles, the last one short; every kernel must have been
   launched by it, and the outputs must be finite, of the right shapes,
   with valid detections, and equal to a direct ``forward_inference`` of
   the same batch (first and short last batch).
4. ``profile``: device time by kernel over two more batches of the main
   path (torch.profiler) and the device's busy share of the wall clock.

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# |kernel - plain| <= 2^-8·|plain| + 1e-4: one bf16 rounding of the output
# (half an ulp, at most 2^-8 relative) over f32 sums of 16 taps taken in
# another order (kernel (wy·wx)·f per tap, plain (Σ wy·f)·wx; ~1e-5 at the
# pooled values' magnitude of ~4). A misplaced sample costs ~1e-1.
REL_TOL, ABS_TOL = 2.0 ** -8, 1e-4
B, C, TILE = 64, 256, 256
POOLERS = (("box", 32, 7), ("mask", 8, 14))


def _require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def _emit(obj: dict):
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from roadsurf_tpu_torch.ops import roi_align_kernel

    builders = {"roi_align": roi_align_kernel.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as ex:
        futs = {name: ex.submit(fn) for name, fn in builders.items()}
        res = {name: f.result() for name, f in futs.items()}
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": {name: {"seconds": r["seconds"], "cached": r["cached"],
                              "ptxas": [ln.strip() for ln in
                                        r["log"].splitlines()
                                        if "registers" in ln
                                        or "spill" in ln]}
                       for name, r in res.items()}})
    return res


def _pool_inputs(g, R: int, edge: bool):
    """Levels (B, H, W, C) bf16 and boxes (B, R, 4) f32 on the generator's
    device; the edge batch puts designed boxes first in every image."""
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
        ], dtype=torch.float32, device=dev)
        k = min(R, len(special))
        boxes[:, :k] = special[:k]
    return feats, boxes.contiguous()


def _work(feats, boxes, lvl, P: int, s: int, min_level: int = 2):
    """(bytes, FLOPs) this call needs: the feature cells its boxes' taps
    touch (each read once), boxes and levels read, the output written; 2
    FLOPs per tap of each valid sample."""
    from roadsurf_tpu_torch.ops.roi_align_kernel import axis_weights

    nbytes = boxes.numel() * 4 + lvl.numel() * 4 \
        + boxes.shape[0] * boxes.shape[1] * P * P * C * 2
    flops = 0.0
    for wy, wx in axis_weights(feats, boxes, lvl, P, s, min_level):
        rows = (wy > 0).any(dim=2).float()                    # (B, R, H)
        cols = ((wx > 0).any(dim=2) & (wy > 0).any(dim=(2, 3))[..., None]
                ).float()                                     # (B, R, W)
        touched = torch.einsum("brh,brw->bhw", rows, cols) > 0
        nbytes += int(touched.sum()) * C * 2
        # a valid sample's taps sum to 1/s on its axis
        ny = torch.round(wy.sum(-1) * s)                      # (B, R, P)
        nx = torch.round(wx.sum(-1) * s)
        flops += float((ny.sum(-1) * nx.sum(-1)).sum()) * 4 * 2 * C
    return nbytes, flops


def phase_kernels() -> dict:
    from roadsurf_tpu_torch.ops.roi_align import level_assignment, \
        reachable_levels
    from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused, \
        roi_align_fused_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for edge in (False, True):
        for name, R, P in POOLERS:
            feats, boxes = _pool_inputs(g, R, edge)
            n_lev = reachable_levels(feats)
            _require(n_lev == 3, f"{n_lev} reachable levels at 256 px")
            lvl = level_assignment(boxes, 224, 4, 2, 2 + n_lev - 1) \
                .contiguous()
            got = roi_align_fused(feats, boxes, lvl, P, 2)
            ref = roi_align_fused_ref(feats, boxes, lvl, P, 2)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            excess = err - (REL_TOL * ref.abs() + ABS_TOL)
            bad = int((excess > 0).sum())
            case = {"pooler": name, "edge": edge, "B": B, "R": R, "P": P,
                    "C": C, "levels": [f.shape[1] for f in feats],
                    "boxes_per_level": torch.bincount(
                        lvl.flatten(), minlength=n_lev).tolist(),
                    "max_abs_err": float(err.max()),
                    "max_abs_ref": float(ref.abs().max()),
                    "out_of_tolerance": bad,
                    "max_excess_over_tolerance": float(excess.max()),
                    "finite": bool(torch.isfinite(got.float()).all())}
            if not edge:
                nbytes, flops = _work(feats, boxes, lvl, P, 2)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / F32_FLOPS_PER_S * 1e3
                case.update(
                    ms=_time_ms(lambda: roi_align_fused(feats, boxes, lvl,
                                                        P, 2), 50),
                    plain_ms=_time_ms(lambda: roi_align_fused_ref(
                        feats, boxes, lvl, P, 2), 5),
                    bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
            _emit({"phase": "kernels", "kernel": "roi_align", **case})
            _require(case["finite"] and bad == 0,
                     f"roi_align disagrees with its plain version: {case}")
            cases.append(case)
    return {"roi_align": cases}


def phase_main_path(n_batches: int = 7, tail: int = 40) -> dict:
    from roadsurf_tpu_torch.engine import TileInferenceEngine
    from roadsurf_tpu_torch.models import fast_profile, forward_inference, \
        init_params
    from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused
    from roadsurf_tpu_torch.utils.weights import from_jax_params

    cfg = fast_profile(post_nms_topk=32)
    gen = torch.Generator().manual_seed(0)
    tree = init_params(cfg, gen)
    # the reference zero-inits the residual branches' FrozenBN scales;
    # give them values so every conv of the backbone computes
    for stage in ("res2", "res3", "res4", "res5"):
        for bp in tree["backbone"][stage]:
            sc = bp["conv3"]["scale"]
            bp["conv3"]["scale"] = 0.1 + 0.2 * torch.rand(sc.shape,
                                                           generator=gen)
    eng = TileInferenceEngine(from_jax_params(tree), cfg, batch_size=B)
    rng = np.random.default_rng(0)
    sizes = [B] * (n_batches - 1) + [tail]
    batches = [rng.integers(0, 256, (n, TILE, TILE, 3), np.uint8)
               for n in sizes]
    warm = rng.integers(0, 256, (B, TILE, TILE, 3), np.uint8)

    roi_align_fused.launches = 0
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
    launches = {"roi_align": roi_align_fused.launches}

    dispatched = 1 + len(batches)
    _require(launches["roi_align"] == 2 * dispatched,
             f"roi_align launched {launches['roi_align']} times for "
             f"{dispatched} batches (2 per batch expected)")
    _require([o["valid"].shape[0] for o in outs] == sizes,
             "batch sizes not trimmed back")
    D = cfg.detections_per_image
    n_valid = 0
    for o, n in zip(outs, sizes):
        _require(o["boxes"].shape == (n, D, 4)
                 and o["scores"].shape == (n, D)
                 and o["classes"].shape == (n, D)
                 and o["valid"].shape == (n, D)
                 and o["mask_logits"].shape == (n, D, 28, 28),
                 f"unexpected shapes {({k: v.shape for k, v in o.items()})}")
        for k in ("boxes", "scores", "mask_logits"):
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
            (B - n, TILE, TILE, 3), np.uint8)])
        ref = forward_inference(eng.state, padded, cfg)
        for k, v in ref.items():
            r = v.cpu().numpy()[:n]
            _require(outs[i][k].dtype == r.dtype, f"{k}: dtype differs")
            if k in ("valid", "classes"):
                _require(np.array_equal(outs[i][k], r),
                         f"batch {i} {k}: engine != forward")
            else:
                d = float(np.abs(outs[i][k].astype(np.float64) - r).max())
                engine_max_diff = max(engine_max_diff, d)
    _require(engine_max_diff <= 1e-3,
             f"engine differs from the forward by {engine_max_diff}")
    tiles = sum(sizes)
    ms = start.elapsed_time(end)
    res = {"phase": "main_path", "profile": "fast_profile(post_nms_topk=32)",
           "dtype": cfg.compute_dtype, "batch": B, "batches": sizes,
           "tiles": tiles, "tiles_per_s": tiles / (ms / 1e3),
           "event_ms": ms, "wall_s": wall,
           "h2d_s": eng.stats["h2d_s"] - stats0["h2d_s"],
           "d2h_s": eng.stats["d2h_s"] - stats0["d2h_s"],
           "valid_detections": n_valid, "launches": launches,
           "engine_vs_forward_max_abs_diff": engine_max_diff,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    _emit(res)
    return res, eng, batches


def _category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("roi_align", ("roi_align",)),
                      ("conv", ("conv", "xmma", "implicit", "cudnn",
                                "nhwc", "winograd")),
                      ("gemm", ("gemm", "cutlass", "cublas", "matmul")),
                      ("sort/top-k", ("sort", "radix", "topk")),
                      ("copy", ("memcpy", "memset", "copy"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def phase_profile(eng, batches, n: int = 2) -> dict:
    """Device time by kernel over ``n`` steady batches of the main path
    (torch.profiler, CUPTI), and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(eng.run(iter(batches[:n])))
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
    busy = sum(k[1] for k in kernels)
    cats: dict = {}
    for name, ms, _ in kernels:
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    res = {"phase": "profile", "batches": n, "tiles": n * B,
           "wall_ms": wall * 1e3, "device_ms": busy,
           "device_busy_share": busy / (wall * 1e3) if wall else None,
           "device_ms_by_category": cats,
           "top_kernels": [{"name": k[0][:120], "ms": k[1], "count": k[2]}
                           for k in kernels[:12]]}
    _emit(res)
    return res


def _toolchain() -> dict:
    from importlib import metadata

    from roadsurf_tpu_torch.ops.roi_align_kernel import nvcc_path

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import roadsurf_tpu_torch  # noqa: F401  (fails outside the repository)

    # the plain versions are the references: their f32 products in full
    # f32, not TF32 (the main path computes in bf16 either way)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    _emit({"phase": "toolchain", **_toolchain(), "card": smi})
    phase_build()
    kern = phase_kernels()
    main_res, eng, batches = phase_main_path()
    phase_profile(eng, batches)

    main_cases = [c for c in kern["roi_align"] if not c["edge"]]
    t_bytes = sum(c["bytes"] for c in main_cases) / HBM_BYTES_PER_S
    t_ops = sum(c["flops"] for c in main_cases) / F32_FLOPS_PER_S
    _emit({"kernels": [{
        "name": "roi_align", "route": "cuda",
        "source": "roadsurf_tpu_torch/csrc/roi_align.cu",
        "replaces": "roadsurf_tpu/ops/roi_align_pallas.py:638",
        "launches": main_res["launches"]["roi_align"],
        "max_abs_err": max(c["max_abs_err"] for c in kern["roi_align"]),
        # one forward's pooling: the box and the mask pooler, summed
        "ms": sum(c["ms"] for c in main_cases),
        "plain_ms": sum(c["plain_ms"] for c in main_cases),
        "bound_ms": sum(c["bound_ms"] for c in main_cases),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "per_pooler": {c["pooler"]: {k: c[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            for c in main_cases}}]})
    print(smi)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
