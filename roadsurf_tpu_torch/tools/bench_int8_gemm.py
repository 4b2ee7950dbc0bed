"""The int8 GEMM at the backbone's 1x1-conv shapes: K4 against the card's
library GEMMs, bf16 and int8.

    python -m roadsurf_tpu_torch.tools.bench_int8_gemm [--device cuda]

A port of the reference package's ``scripts/bench_int8_gemm.py``: the
seven (M, K, N) of the script, M = 512·H·W (the deployment batch at
256 px; ``chip_smoke.GEMMS`` holds the same GEMMs at B=64), each in three
variants under the script's names:

* ``xla-bf16``: the int8 operands cast to bf16, then ``torch.matmul``
  (cuBLAS; bf16 out, float32 sums), the casts timed with it;
* ``xla-i8``: ``torch._int_mm``, int8 x int8 -> int32 (cuBLASLt);
* ``pl-i8``: K4, ``ops.int8_gemm.int8_gemm`` (``csrc/int8_gemm.cu``),
  raw int32 out.

``w`` is the script's (``default_rng(0)``, one a shape); each of
``BENCH_STEPS`` (3) steps after a warm-up one runs ``BENCH_KREP`` (8)
GEMMs on distinct ``a`` drawn on the device before the step's clock
starts, and fetches one element of each output (``bench_common.
time_reps``). Prints the script's lines (ms a GEMM and TF/s) with the
event ms, and one JSON line a variant: rates against the card's dense
int8 peak (1,979 TOP/s) and bf16 peak (989 TFLOP/s).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ops.int8_gemm import int8_gemm
from ..utils.device import resolve_device
from .bench_common import BF16_PEAK, INT8_PEAK, card, emit, \
    time_reps

BATCH = 512


def shapes(batch: int = BATCH) -> list:
    """(tag, M, K, N): the backbone's 1x1 shapes at ``batch`` (M =
    batch·H·W) and the box head's FC1 (batch·32 ROIs)."""
    return [("C2 1x1 256>64", batch * 64 * 64, 256, 64),
            ("C3 1x1 512>128", batch * 32 * 32, 512, 128),
            ("C3 1x1 128>512", batch * 32 * 32, 128, 512),
            ("C4 1x1 1024>256", batch * 16 * 16, 1024, 256),
            ("C4 1x1 256>1024", batch * 16 * 16, 256, 1024),
            ("C5 1x1 2048>512", batch * 8 * 8, 2048, 512),
            ("boxFC1 16k ROIs", batch * 32, 7 * 7 * 256, 1024)]


def settings(env=None) -> dict:
    """The script's knobs: {krep, steps}."""
    env = os.environ if env is None else env
    return {"krep": int(env.get("BENCH_KREP", "8")),
            "steps": int(env.get("BENCH_STEPS", "3"))}


def variants() -> list:
    """[(name, fn(a, w), peak)] in the script's order."""
    return [("xla-bf16", lambda a, w: torch.matmul(
                a.to(torch.bfloat16), w.to(torch.bfloat16)), BF16_PEAK),
            ("xla-i8", lambda a, w: torch._int_mm(a, w), INT8_PEAK),
            ("pl-i8", lambda a, w: int8_gemm(a, w), INT8_PEAK)]


def run(env=None, device="cuda", batch: int = BATCH) -> list:
    """The benchmark at the knobs of ``env`` (default: the process's);
    ``batch`` scales M (the tests run cut shapes). Returns the rows."""
    dev = resolve_device(device)
    s = settings(env)
    krep, steps = s["krep"], s["steps"]
    name = card(dev)
    print("device:", name, flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for tag, M, K, N in shapes(batch):
        flops = 2.0 * M * K * N
        print(f"{tag}  M={M} K={K} N={N}  {flops / 1e9:.0f} GFLOP",
              flush=True)
        w = torch.from_numpy(rng.integers(-127, 127, (K, N), np.int8)).to(dev)

        def make(step, _M=M, _K=K):
            g = torch.Generator(device=dev).manual_seed(1000 * step + 1)
            return [(torch.randint(-127, 127, (_M, _K), generator=g,
                                   device=dev, dtype=torch.int8), w)
                    for _ in range(krep)]

        for vname, fn, peak in variants():
            with torch.inference_mode():
                t = time_reps(fn, make, steps)
            ms = t["event_ms"] if t["event_ms"] is not None else t["ms"]
            tf = flops / (ms / 1e3) / 1e12
            print(f"  {vname:10s} {ms:7.3f} ms  {tf:6.1f} TF/s"
                  f"  (host {t['ms']:7.3f} ms)", flush=True)
            row = {"shape": tag, "M": M, "K": K, "N": N, "variant": vname,
                   "ms": t["ms"], "event_ms": t["event_ms"],
                   "tflops": tf, "peak_share": flops / (ms / 1e3) / peak,
                   "krep": krep, "steps": steps, "card": name}
            rows.append(row)
            emit(row)
        del w
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="K4 against torch.matmul (bf16) and torch._int_mm at "
                    "the backbone's 1x1 shapes (knobs: BENCH_KREP, "
                    "BENCH_STEPS).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
