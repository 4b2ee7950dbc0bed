"""The conv dtype paths at the backbone's and FPN's shapes: int8 compute
against int8 storage with bf16 compute, and bf16.

    python -m roadsurf_tpu_torch.tools.bench_conv_dtypes [--device cuda]

A port of the reference package's ``scripts/bench_conv_dtypes.py``: its
seven conv shapes at the deployment batch 512 (256 px tiles), each in the
script's variants:

* ``i8/i32``: the port's exact int8 conv (``models.quant.
  qconv_int8_in``'s product): int8 operands as float32 into a cuDNN conv,
  TF32 allowed (int8 values and their products are exact there), float32
  out; where the shape is 1x1 also ``i8/K4``: the same product as K4's
  GEMM (``ops.int8_gemm.int8_gemm``, int32 out) over the NHWC rows;
* ``i8>bf16``: the int8 operands cast to bf16, then a bf16 cuDNN conv;
* ``bf16``: bf16 operands stored, a bf16 conv.

The layouts are the model's (NCHW in channels_last memory, OIHW weights,
the reference's padding). The inputs are int8 ``3·N(0, 1)`` (truncated),
drawn on the device; each of ``BENCH_STEPS`` (3) steps after a warm-up
one runs ``BENCH_KREP`` (8) convs on distinct inputs made before the
step's clock starts and fetches one element of each output
(``bench_common.time_reps``). FLOPs 2·B·Ho·Wo·kh·kw·Cin·Cout. Prints the
script's line a shape (ms and TF/s a variant) and one JSON line a
variant.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.nn.functional as F

from ..models.quant import tf32
from ..ops.int8_gemm import int8_gemm
from ..utils.device import resolve_device
from .bench_common import card, emit, time_reps

BATCH = 512


def shapes(batch: int = BATCH) -> list:
    """(tag, B, H, W, Cin, Cout, k, stride), the script's."""
    return [("C2 3x3 64", batch, 64, 64, 64, 64, 3, 1),
            ("C2 1x1 64>256", batch, 64, 64, 64, 256, 1, 1),
            ("C3 3x3 128", batch, 32, 32, 128, 128, 3, 1),
            ("C4 3x3 256", batch, 16, 16, 256, 256, 3, 1),
            ("C5 3x3 512", batch, 8, 8, 512, 512, 3, 1),
            ("FPN out 3x3", batch, 64, 64, 256, 256, 3, 1),
            ("FPN lat C5", batch, 8, 8, 2048, 256, 1, 1)]


def settings(env=None) -> dict:
    """The script's knobs: {krep, steps}."""
    env = os.environ if env is None else env
    return {"krep": int(env.get("BENCH_KREP", "8")),
            "steps": int(env.get("BENCH_STEPS", "3"))}


def _conv(x, w, stride: int):
    k = w.shape[-1]
    return F.conv2d(x, w, stride=stride, padding=k // 2)


def variants(k: int, stride: int) -> list:
    """[(name, fn(x, w), operands' dtype)] for a shape: ``x`` (B, C, H, W)
    channels_last, ``w`` (Cout, Cin, k, k), int8 or bf16."""
    def i8_i32(x, w):
        with tf32(True):
            return _conv(x.float(), w.float(), stride)

    out = [("i8/i32", i8_i32, torch.int8)]
    if k == 1 and stride == 1:
        def i8_k4(x, w):
            a = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
            return int8_gemm(a, w[:, :, 0, 0].t().contiguous())
        out.append(("i8/K4", i8_k4, torch.int8))
    out += [("i8>bf16", lambda x, w: _conv(
                x.to(torch.bfloat16), w.to(torch.bfloat16), stride),
             torch.int8),
            ("bf16", lambda x, w: _conv(x, w, stride), torch.bfloat16)]
    return out


def inputs(step: int, krep: int, shape: tuple, dtype, dev) -> list:
    """``krep`` distinct (x, w) of a step, int8 ``3·N(0, 1)`` truncated
    (bf16: the same values)."""
    _, B, H, W, Ci, Co, k, _ = shape
    g = torch.Generator(device=dev).manual_seed(1000 * step + 7)
    out = []
    for _ in range(krep):
        x = (torch.randn((B, H, W, Ci), generator=g, device=dev) * 3).to(
            torch.int8).to(dtype).permute(0, 3, 1, 2)
        w = (torch.randn((Co, k, k, Ci), generator=g, device=dev) * 3).to(
            torch.int8).to(dtype).permute(0, 3, 1, 2).contiguous()
        out.append((x, w))
    return out


def run(env=None, device="cuda", batch: int = BATCH) -> list:
    """The benchmark at the knobs of ``env`` (default: the process's);
    ``batch`` overrides the deployment batch (the tests run cut shapes).
    Returns the rows."""
    dev = resolve_device(device)
    s = settings(env)
    krep, steps = s["krep"], s["steps"]
    name = card(dev)
    rows = []
    for shape in shapes(batch):
        tag, B, H, W, Ci, Co, k, st = shape
        fl = 2 * B * (H // st) * (W // st) * k * k * Ci * Co
        parts = []
        for vname, fn, dtype in variants(k, st):
            with torch.inference_mode():
                t = time_reps(fn, lambda step, _d=dtype: inputs(
                    step, krep, shape, _d, dev), steps)
            ms = t["event_ms"] if t["event_ms"] is not None else t["ms"]
            parts.append(f"{vname} {ms:6.3f}ms={fl / ms / 1e9:4.0f}TF/s")
            row = {"shape": tag, "variant": vname, "ms": t["ms"],
                   "event_ms": t["event_ms"], "tflops": fl / ms / 1e9,
                   "flops": fl, "krep": krep, "steps": steps, "card": name}
            rows.append(row)
            emit(row)
        print(f"{tag:16s} {'  '.join(parts)}", flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="int8 and bf16 conv paths at the backbone's and FPN's "
                    "shapes (knobs: BENCH_KREP, BENCH_STEPS).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
