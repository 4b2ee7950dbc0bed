"""Attribute K1's time at the deployment box pooler to the phases of its
kernel.

    python -m roadsurf_tpu_torch.tools.bench_pooler_variants [--device cuda]

A port of the reference package's ``scripts/bench_pooler_variants.py``:
the fast profile's box pooler (``BENCH_BATCH`` 512, R=32 proposals, P=7,
P2..P4 of a 256 px tile, C=256, sampling 2), or with ``BENCH_POOLER=mask``
its mask pooler (R=8, P=14); bf16 N(0, 1) levels, or with ``BENCH_INT8=1``
int8 levels and per-level scales (0.11, 0.23, 0.47), the deployment
input; boxes with corners in [0, 200) and sides in [8, 56), clipped to
256. Each step's inputs are drawn on the device before the clock starts;
``BENCH_STEPS`` (3) steps after a warm-up one, each forced to complete by
fetching the sum of channel 0; ``BENCH_CASES`` keeps the rows whose name
holds it.

The reference attributes its Pallas kernel's time through a ``stage``
knob of that kernel (its weights, its y-matmul, its relayout). The card's
kernel has other phases (``csrc/roi_align_staged.cuh``): the weights into
shared memory, the bulk-copy staging of the rows of non-zero weight (with
the int8 cells' dequantization), the x-pass, the y-accumulate. Each is a
compile-time stage of that header, ``ROI_ALIGN_STAGE`` (0 to 3), built
here into a library of its own (``ops.cuda_build.library("roi_align",
(("ROI_ALIGN_STAGE", n),))``); the main path's libraries are built without
it, and take the whole kernel (3). The rows ``stage=weights``,
``stage=copy``, ``stage=xpass`` stop after their phase and compute wrong
results on purpose (the difference of consecutive rows is a phase's
cost); ``full`` is K1 as the main path launches it (``roi_align_fused``);
``full out=bf16`` is the same call, since K1 writes bf16 for bf16 and
int8 levels; ``blocked`` is K2's kernel (``roi_align_fused_blocked``,
``csrc/roi_align_blocked.cu``) on the same inputs. The script's rows with
no CUDA counterpart (``NO_COUNTERPART``: its TPU layout devices) are
printed as such.

Prints one line a row (ms a batch, host and event) and one JSON line a
row (``bench_common``). The stage rows are not kernels of the port: they
count no launch.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
from types import SimpleNamespace

import torch

from ..ops import cuda_build
from ..ops.roi_align import level_assignment
from ..ops.roi_align_blocked_kernel import roi_align_fused_blocked
from ..ops.roi_align_kernel import POOLER_ARGTYPES, _check, launch_pooler, \
    roi_align_fused
from ..utils.device import resolve_device
from .bench_common import card, emit, time_steps

SIZES = ((64, 64), (32, 32), (16, 16))
C = 256
INT8_SCALES = (0.11, 0.23, 0.47)
STAGES = (("stage=weights", 0), ("stage=copy", 1), ("stage=xpass", 2))
# the script's rows that time the TPU kernel's layout devices (the
# relayout copies, image grouping, the box block, its row block): the
# card's kernel has none of them (ops/roi_align_kernel.py)
NO_COUNTERPART = ("stage=y", "stage=yr", "stage=yr relay=t", "full relay=t",
                  "full relay=t gb=8", "full rbx=8", "full rbx=32",
                  "full gb=2", "full gb=4", "full gb=8", "full gb=16",
                  "full gb=32", "blocked rb=32", "blocked rb=64")


def settings(env=None) -> dict:
    """The script's knobs: {batch, steps, R, P, int8, cases}."""
    env = os.environ if env is None else env
    R, P = (8, 14) if env.get("BENCH_POOLER", "box") == "mask" else (32, 7)
    return {"batch": int(env.get("BENCH_BATCH", "512")),
            "steps": int(env.get("BENCH_STEPS", "3")), "R": R, "P": P,
            "int8": env.get("BENCH_INT8", "0") == "1",
            "cases": env.get("BENCH_CASES", "")}


def stage_pooler(stage: int):
    """K1's entry point built with ``ROI_ALIGN_STAGE=stage``, called as
    ``roi_align_fused`` is; its launches are counted on a wrapper of its
    own, not on K1's."""
    lib = cuda_build.library("roi_align", (("ROI_ALIGN_STAGE", stage),))
    lib.roi_align_run.argtypes = POOLER_ARGTYPES
    lib.roi_align_run.restype = ctypes.c_int
    counts = SimpleNamespace(launches=0, launches_int8=0, launches_f32=0)

    def pool(feats, boxes, lvl, P, sampling, feat_scales=None):
        _check(feats, boxes, lvl, P, sampling, feat_scales)
        return launch_pooler(counts, "roi_align", lib.roi_align_run, feats,
                             boxes, lvl, P, sampling, 2, feat_scales)
    return pool


def rows(env=None) -> list:
    """[(name, fn(feats, boxes, lvl, scales) or None)]: the tool's rows
    in order, then the script's rows with no counterpart (None)."""
    s = settings(env)
    P = s["P"]
    out = [(name, lambda f, b, l, sc, _n=n: stage_pooler(_n)(
        f, b, l, P, 2, feat_scales=sc)) for name, n in STAGES]
    full = (lambda f, b, l, sc: roi_align_fused(f, b, l, P, 2,
                                                feat_scales=sc))
    out += [("full", full), ("full out=bf16", full),
            ("blocked", lambda f, b, l, sc: roi_align_fused_blocked(
                f, b, l, P, 2, feat_scales=sc))]
    out += [(name, None) for name in NO_COUNTERPART]
    return [r for r in out if not s["cases"] or s["cases"] in r[0]]


def inputs(seed: int, B: int, R: int, int8: bool, dev) -> tuple:
    """(levels, boxes, levels' index a box, scales or None) on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if int8:
        feats = tuple(torch.randint(-127, 128, (B, h, w, C), generator=g,
                                    device=dev, dtype=torch.int8)
                      for h, w in SIZES)
        scales = torch.tensor(INT8_SCALES, dtype=torch.float32, device=dev)
    else:
        feats = tuple(torch.randn((B, h, w, C), generator=g, device=dev)
                      .to(torch.bfloat16) for h, w in SIZES)
        scales = None
    x0 = torch.rand((B, R, 2), generator=g, device=dev) * 200.0
    wh = 8.0 + torch.rand((B, R, 2), generator=g, device=dev) * 48.0
    boxes = torch.cat([x0, (x0 + wh).clamp(max=256.0)], -1).contiguous()
    return feats, boxes, level_assignment(boxes, 224, 4, 2, 4).contiguous(), \
        scales


def run(env=None, device="cuda", batch: int | None = None,
        steps: int | None = None) -> list:
    """The attribution at the knobs of ``env`` (default: the process's);
    ``batch`` and ``steps`` override them. Returns the rows."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the kernel's stages run on the card only")
    s = settings(env)
    B = batch or s["batch"]
    steps = steps or s["steps"]
    name_card = card(dev)
    out, seed = [], 0
    for name, fn in rows(env):
        if fn is None:
            print(f"{name:18s} no CUDA counterpart", flush=True)
            row = {"case": name, "counterpart": None}
        else:
            ins = []
            for _ in range(steps + 1):
                seed += 1
                ins.append(inputs(seed, B, s["R"], s["int8"], dev))
            print(f"... {name}: building", file=sys.stderr, flush=True)
            with torch.inference_mode():
                t = time_steps(fn, ins, reduce=lambda y: y[..., 0].float()
                               .sum())
            print(f"{name:18s} {t['ms']:8.2f} ms/batch  event "
                  f"{t['event_ms']:8.3f} ms", flush=True)
            row = {"case": name, "ms_per_batch": t["ms"],
                   "event_ms_per_batch": t["event_ms"], "batch": B,
                   "R": s["R"], "P": s["P"], "int8": s["int8"],
                   "steps": steps, "card": name_card}
            del ins
        out.append(row)
        emit(row)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="K1's time by kernel phase at the fast profile's "
                    "poolers (knobs: BENCH_BATCH, BENCH_STEPS, "
                    "BENCH_POOLER, BENCH_INT8, BENCH_CASES).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
