"""The fast profile's pooler at deployment shapes: K1 against the plain
separable pooler at several image chunk sizes.

    python -m roadsurf_tpu_torch.tools.bench_pooler [--device cuda]

A port of the reference package's ``scripts/bench_pooler.py``: P2..P4 of
a 256 px tile (64, 32, 16 px), C=256, bf16 N(0, 1) levels, at
``BENCH_BATCH`` 512, sampling 2; boxes with corners uniform in [0, 200)
and sides in [8, 56), clipped to 256; the box pooler's (R=32 and 64, P=7)
and the mask pooler's (R=8, P=14) geometries. Each step's levels and
boxes are drawn on the device (a ``torch.Generator`` seeded anew a step)
before the clock starts; ``BENCH_STEPS`` (3) steps after a warm-up one,
each forced to complete by fetching the sum of channel 0.

The rows keep the script's names: ``separable ic=N R= P=`` is the plain
version (``ops.roi_align_kernel.roi_align_fused_ref``, float32 out) run N
images at a time, and ``pallas R= P=`` is K1 (``roi_align_fused``,
``csrc/roi_align.cu``), the kernel that replaces the script's Pallas one.
``BENCH_PALLAS=0`` leaves K1 out; ``BENCH_CASES`` keeps the rows whose
name holds it. Prints the script's lines with the event ms, and one JSON
line a row (``bench_common``).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..ops.roi_align import level_assignment
from ..ops.roi_align_kernel import roi_align_fused, roi_align_fused_ref
from ..utils.device import resolve_device
from .bench_common import card, emit, time_steps

SIZES = ((64, 64), (32, 32), (16, 16))
C = 256
GEOMETRIES = ((32, 7), (64, 7), (8, 14))
CHUNKS = (4, 16, 64)


def settings(env=None) -> dict:
    """The script's knobs: {batch, steps, pallas, cases}."""
    env = os.environ if env is None else env
    return {"batch": int(env.get("BENCH_BATCH", "512")),
            "steps": int(env.get("BENCH_STEPS", "3")),
            "pallas": env.get("BENCH_PALLAS", "1") == "1",
            "cases": env.get("BENCH_CASES", "")}


def inputs(seed: int, B: int, R: int, dev) -> tuple:
    """(levels, boxes, levels' index a box) drawn on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = tuple(torch.randn((B, h, w, C), generator=g, device=dev)
                  .to(torch.bfloat16) for h, w in SIZES)
    x0 = torch.rand((B, R, 2), generator=g, device=dev) * 200.0
    wh = 8.0 + torch.rand((B, R, 2), generator=g, device=dev) * 48.0
    boxes = torch.cat([x0, (x0 + wh).clamp(max=256.0)], -1).contiguous()
    lvl = level_assignment(boxes, 224, 4, 2, 4).contiguous()
    return feats, boxes, lvl


def cases(pallas: bool = True, only: str = "") -> list:
    """[(name, fn(feats, boxes, lvl), R)]: the plain rows first, then K1's
    (as the script orders them)."""
    out = []
    for R, P in GEOMETRIES:
        for ic in CHUNKS:
            def sep(feats, boxes, lvl, _P=P, _ic=ic):
                return torch.cat([roi_align_fused_ref(
                    tuple(f[i:i + _ic] for f in feats), boxes[i:i + _ic],
                    lvl[i:i + _ic], _P, 2)
                    for i in range(0, boxes.shape[0], _ic)])
            out.append((f"separable ic={ic} R={R} P={P}", sep, R))
    if pallas:
        for R, P in GEOMETRIES:
            out.append((f"pallas R={R} P={P}",
                        lambda feats, boxes, lvl, _P=P: roi_align_fused(
                            feats, boxes, lvl, _P, 2), R))
    return [c for c in out if not only or only in c[0]]


def run(env=None, device="cuda", batch: int | None = None,
        steps: int | None = None) -> list:
    """The benchmark at the knobs of ``env`` (default: the process's);
    ``batch`` and ``steps`` override them. Returns the rows."""
    dev = resolve_device(device)
    s = settings(env)
    B = batch or s["batch"]
    steps = steps or s["steps"]
    rows, seed = [], 0
    for name, fn, R in cases(s["pallas"], s["cases"]):
        ins = []
        for _ in range(steps + 1):
            seed += 1
            ins.append(inputs(seed, B, R, dev))
        print(f"... {name}: compiling", file=sys.stderr, flush=True)
        try:
            with torch.inference_mode():
                t = time_steps(fn, ins, reduce=lambda y: y[..., 0].float()
                               .sum())
            ev = t["event_ms"]
            print(f"{name:28s} {t['ms']:8.2f} ms/batch"
                  + ("" if ev is None else f"  event {ev:8.2f} ms"),
                  flush=True)
            row = {"case": name, "ms_per_batch": t["ms"],
                   "event_ms_per_batch": ev, "batch": B, "steps": steps,
                   "card": card(dev)}
        except RuntimeError as e:
            print(f"{name:28s} FAILED {type(e).__name__}: {e}", flush=True)
            row = {"case": name, "error": f"{type(e).__name__}: {e}"[:400]}
        rows.append(row)
        emit(row)
        del ins
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="K1 against the plain pooler at the fast profile's "
                    "shapes (knobs: BENCH_BATCH, BENCH_STEPS, BENCH_PALLAS, "
                    "BENCH_CASES).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    rows = run(device=args.device)
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
