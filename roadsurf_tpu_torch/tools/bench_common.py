"""What the port's profiles and microbenchmarks share (``tools/profile_*``
and ``tools/bench_*``): the card, staged inputs, timing with forced
completion, FLOP counts and the card's peaks.

The reference's scripts measure through a relayed TPU, and each of their
habits has its counterpart on the card here:

* distinct inputs: each timed step gets inputs of its own, made and put on
  the device before the clock starts (there against the relay's dispatch
  cache; here so that no step reads what a cache kept of the last);
* forced completion: one scalar is fetched a step (``.item()``), and the
  host clock spans the steps (``time_lag1``: fetched one step late, as
  ``bench.py`` pipelines them); beside it, CUDA events around each step's
  work give its device span (``event_ms``, without the fetch);
* the "noop (dispatch floor)" rows: an almost empty call plus the fetch,
  the floor every other row stands on;
* stage boundaries: eager PyTorch writes every output a stage returns,
  so the scalar is a sum over all of them and nothing is elided;
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one call, in
  place of XLA's ``cost_analysis()``. It counts convolutions and matrix
  products only: the poolers (K1, K2, K5), the NMS, the elementwise work
  and the int8 GEMM kernel (K4) are not in any GFLOP or MFU figure;
* peaks: the published dense peaks of the H100 SXM (NVIDIA's data sheet),
  989 TFLOP/s bf16 and 1,979 TOP/s int8, at its 700 W power limit; a
  card set to a lower limit runs slower under load, so every tool prints
  the card's name and limit (``card()``).

Every tool raises without a card unless it is given ``device="cpu"``,
before it times anything.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from ..utils.graphs import tensor_leaves

BF16_PEAK = 989e12              # H100 SXM dense bf16, FLOP/s (data sheet)
INT8_PEAK = 1979e12             # H100 SXM dense int8, OP/s (data sheet)
PEAKS = "H100 SXM dense peaks (NVIDIA data sheet) at 700 W"
FLOPS_COUNTED = "convolutions and matrix products (FlopCounterMode)"


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def scalar(tree) -> torch.Tensor:
    """The float32 sum of every element of every tensor of ``tree``."""
    return sum(t.float().sum() for t in tensor_leaves(tree))


def flop_count(fn, *args) -> float:
    """FLOPs of one ``fn(*args)`` call, convolutions and matrix products
    only (``FlopCounterMode``)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops())


def time_steps(fn, inputs: list, reduce=scalar) -> dict:
    """``fn(*inputs[0])`` once to warm up, then one step each of
    ``inputs[1:]``, each forced to complete by fetching ``reduce`` of its
    result. Returns the mean host ms a step (``ms``, the fetch included)
    and, on the card, the mean event ms of ``fn`` alone (``event_ms``);
    and the last step's scalar."""
    cuda = any(t.is_cuda for t in tensor_leaves(inputs[0]))
    value = float(reduce(fn(*inputs[0])))
    spans = []
    t0 = time.perf_counter()
    for args in inputs[1:]:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            spans.append((start, end))
        else:
            out = fn(*args)
        value = float(reduce(out))
        del out
    ms = (time.perf_counter() - t0) * 1e3 / max(1, len(inputs) - 1)
    event_ms = sum(s.elapsed_time(e) for s, e in spans) / len(spans) \
        if spans else None
    return {"ms": ms, "event_ms": event_ms, "scalar": value}


def time_reps(fn, make_inputs, steps: int) -> dict:
    """Microbenchmark timing: ``make_inputs(s)`` gives step s's list of
    distinct argument tuples (step 0 warms up), made before the step's
    clock starts; a step runs ``fn`` on each and fetches the sum of one
    element of each output. Returns the host ms and the event ms of one
    call (a step's over its calls), averaged over ``steps`` steps."""
    def one(args):
        out = fn(*args)
        return out[(0,) * out.dim()].float()

    float(sum(one(a) for a in make_inputs(0)))
    host = event = 0.0
    n = 0
    for s in range(1, steps + 1):
        inputs = make_inputs(s)
        n = len(inputs)
        cuda = any(t.is_cuda for t in tensor_leaves(inputs))
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        acc = [one(a) for a in inputs]
        if cuda:
            end.record()
        float(sum(acc))
        host += time.perf_counter() - t0
        if cuda:
            event += start.elapsed_time(end) / 1e3
        del inputs
    per = steps * max(n, 1)
    return {"ms": host / per * 1e3,
            "event_ms": event / per * 1e3 if event else None}


def staged(rng, shape: tuple, n: int, dev: torch.device) -> list:
    """``n`` arrays of random uint8 tiles of ``shape`` from ``rng``
    (``integers(0, 255)``, the scripts' draw), each put on ``dev`` as it
    is drawn."""
    return [torch.from_numpy(rng.integers(0, 255, shape, dtype=np.uint8)
                             ).to(dev) for _ in range(n)]


def time_lag1(step, inputs: list) -> dict:
    """``bench.py``'s timed loop, lag-1 pipelined: ``step(x)`` enqueues one
    step and returns its scalar as a tensor of its own (enqueued right
    after the step's work, so no later step can overwrite what it reads);
    each scalar is fetched (``.item()``) after the next step is enqueued,
    the last one after the loop, all inside the host clock. Returns the
    host seconds (``host_s``), the scalars in step order and, on the card,
    the mean event ms of a step's enqueued work (``event_ms``, without the
    fetch)."""
    cuda = any(t.is_cuda for t in tensor_leaves(inputs[0]))
    spans, values = [], []
    prev = None
    t0 = time.perf_counter()
    for x in inputs:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        value = step(x)
        if cuda:
            end.record()
            spans.append((start, end))
        if prev is not None:
            values.append(prev.item())
        prev = value
    values.append(prev.item())
    host_s = time.perf_counter() - t0
    event_ms = sum(s.elapsed_time(e) for s, e in spans) / len(spans) \
        if spans else None
    return {"host_s": host_s, "scalars": values, "event_ms": event_ms}


def emit(obj: dict):
    print(json.dumps(obj), flush=True)
