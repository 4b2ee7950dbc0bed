"""Tile-inference throughput of the Mask R-CNN R50-FPN on one card: the
port of the reference package's benchmark, ``bench.py``.

    python -m roadsurf_tpu_torch.tools.bench [--device cuda]

The knobs and their defaults are the script's:

* ``BENCH_PROFILE``: ``fast`` (any value but ``parity``) is
  ``fast_profile(post_nms_topk=BENCH_TOPK)`` (32) at ``BENCH_BATCH`` 512;
  ``parity`` is ``ModelConfig()``, the 800 px profile, at 16;
* ``BENCH_STEPS`` (3), the timed steps;
* ``BENCH_INT8`` (1): the static-int8 stack, ``int8_scope =
  BENCH_INT8_SCOPE`` (full), with the int8 pyramid where ``BENCH_INT8_PYR``
  is 1 (the default) and the scope is ``convnet`` or ``full``;
* ``BENCH_SCANK`` (16 fast, 4 parity), the batches a call: at k > 1 the
  call is ``models.mask_rcnn.make_inference_scan_fn(cfg,
  with_masks=True)``, on the card one CUDA graph of k forwards captured at
  its first call (``utils/graphs.py``); at k = 1 it is the eager forward.

Its procedure is the script's. Weights from ``init_params`` seeded 0,
the int8 stack calibrated on one ``default_rng(1)`` batch of 8 random
256 px tiles (``profile_stages.model_state``). ``steps`` distinct batches
of random uint8 tiles of shape (k, B, 256, 256, 3) ((B, 256, 256, 3) at
k = 1) from ``default_rng(0)``, then a warm-up batch of their own, all on
the device before the clock starts. The warm-up call (on the card: the
graph's capture and its first replay) runs outside the timed window. The
timed steps are pipelined lag-1 and each step's score sum is fetched
inside the window (``bench_common.time_lag1``). That sum is enqueued right
after its step's call: a graph's outputs are static tensors that the next
replay overwrites, so a sum taken after the next call would read the next
step's scores. A call copies its input into the graph's static input
(1.61 GB device to device at the fast defaults) inside the window, as the
script times its own dispatch; ``copy_ms`` times that copy alone.

Prints one JSON line of readings (the card's name and power limit, host
seconds, event ms a step, the warm-up call's seconds, the capture's
seconds and memory pool, the input copy's ms, peak memory, each step's
scalar) and, as its last line, the script's own: ``metric``, ``value``
(tiles/s), ``unit`` and ``vs_baseline`` against its 5000 tiles/s.

Raises without a card unless it is given ``device="cpu"``, before it
times anything.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import numpy as np
import torch

from ..models.config import ModelConfig, fast_profile
from ..models.mask_rcnn import forward_prepared, make_inference_scan_fn
from ..utils.device import resolve_device
from ..utils.graphs import tensor_leaves
from .bench_common import card, emit, staged, time_lag1
from .profile_stages import model_state

BASELINE = 5000.0               # the script's north star, tiles/s
TILE = 256
UNIT = "tiles/sec/chip"
COPY_REPS = 5


def settings(env=None) -> dict:
    """The script's knobs: {profile, cfg, batch, steps, scan_k}."""
    env = os.environ if env is None else env
    profile = env.get("BENCH_PROFILE", "fast")
    if profile == "parity":
        cfg = ModelConfig()
        batch = int(env.get("BENCH_BATCH", "16"))
    else:
        cfg = fast_profile(post_nms_topk=int(env.get("BENCH_TOPK", "32")))
        batch = int(env.get("BENCH_BATCH", "512"))
    if env.get("BENCH_INT8", "1") == "1":
        scope = env.get("BENCH_INT8_SCOPE", "full")
        cfg = replace(cfg, int8_scope=scope,
                      int8_pyramid=env.get("BENCH_INT8_PYR", "1") == "1"
                      and scope in ("convnet", "full"))
    return {"profile": profile, "cfg": cfg, "batch": batch,
            "steps": int(env.get("BENCH_STEPS", "3")),
            "scan_k": int(env.get("BENCH_SCANK", "16" if profile != "parity"
                                  else "4"))}


def input_shape(batch: int, scan_k: int, tile: int = TILE) -> tuple:
    """A call's input: k stacked batches at k > 1, one batch at k = 1."""
    one = (batch, tile, tile, 3)
    return (scan_k,) + one if scan_k > 1 else one


def result_line(profile: str, tiles_per_s: float) -> dict:
    """The script's JSON line."""
    return {"metric": "mask_rcnn_r50fpn_256px_tile_inference"
                      if profile != "parity"
                      else "mask_rcnn_r50fpn_parity800_tile_inference",
            "value": round(tiles_per_s, 1), "unit": UNIT,
            "vs_baseline": round(tiles_per_s / BASELINE, 3)}


def _forward(cfg):
    def fn(state, images):
        return forward_prepared(state, images, cfg, True, "logits")
    return fn


class Bench:
    """One setting of the benchmark, staged on its device: the prepared
    weights, the call, the timed batches and the warm-up batch, at the
    knobs of ``env`` (default: the process's). ``cfg``, the tiles' side
    and the weights (``state``, unprepared) stand in for what no knob
    sets, so that the tests can run a narrow model on small tiles."""

    def __init__(self, env=None, device="cuda", cfg: ModelConfig | None = None,
                 tile: int = TILE, state: dict | None = None):
        self.dev = resolve_device(device)
        s = settings(env)
        self.profile = s["profile"]
        self.cfg = cfg or s["cfg"]
        self.batch, self.steps, self.scan_k = s["batch"], s["steps"], \
            s["scan_k"]
        self.shape = input_shape(self.batch, self.scan_k, tile)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.state = model_state(self.cfg, self.dev, tile, state)
        self.fn = make_inference_scan_fn(self.cfg, with_masks=True) \
            if self.scan_k > 1 else _forward(self.cfg)
        rng = np.random.default_rng(0)
        self.batches = staged(rng, self.shape, self.steps, self.dev)
        self.warm = staged(rng, self.shape, 1, self.dev)[0]

    def scalar(self, images: torch.Tensor) -> torch.Tensor:
        """One call on ``images`` and its score sum, enqueued."""
        with torch.inference_mode():
            return self.fn(self.state, images)["scores"].sum()

    def graph(self):
        """The CUDA graph the scan call captured, or None (k = 1, the CPU,
        or before the first call)."""
        graphs = getattr(self.fn, "graphs", {})
        return graphs.get((self.shape, tensor_leaves(self.state)[0].device))

    def alone(self, images: torch.Tensor) -> float:
        """The score sum of one call on ``images`` with nothing else in
        flight."""
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return float(self.scalar(images))

    def _copy_ms(self, graph) -> float:
        """Event ms of the copy of one input into the graph's static input
        (what each call does before its replay)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            start.record()
            for _ in range(COPY_REPS):
                graph.static_in.copy_(self.warm, non_blocking=True)
            end.record()
        torch.cuda.synchronize(self.dev)
        return start.elapsed_time(end) / COPY_REPS

    def measure(self) -> dict:
        """The warm-up call, then the timed lag-1 steps; the readings, and
        the script's JSON line under ``line``."""
        t0 = time.perf_counter()
        float(self.scalar(self.warm))
        first_s = time.perf_counter() - t0
        timed = time_lag1(self.scalar, self.batches)
        tiles_per_s = self.batch * max(self.scan_k, 1) * self.steps \
            / timed["host_s"]
        graph = self.graph()
        cuda = self.dev.type == "cuda"
        return {
            "tool": "bench", "card": card(self.dev), "profile": self.profile,
            "int8_scope": self.cfg.int8_scope,
            "int8_pyramid": self.cfg.int8_pyramid, "batch": self.batch,
            "scan_k": self.scan_k, "steps": self.steps,
            "input_shape": list(self.shape), "tiles_per_s": tiles_per_s,
            "host_s": timed["host_s"],
            "event_ms_per_step": timed["event_ms"],
            "first_call_s": first_s,
            "capture_s": graph.capture_s if graph else None,
            "pool_bytes": graph.pool_bytes if graph else None,
            "copy_ms": self._copy_ms(graph) if graph else None,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(self.dev)
            if cuda else None,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(self.dev)
            if cuda else None,
            "scalars": timed["scalars"],
            "line": result_line(self.profile, tiles_per_s)}

    def close(self):
        """Drop the staged batches and the graph this setting captured."""
        graphs = getattr(self.fn, "graphs", {})
        graphs.pop((self.shape, tensor_leaves(self.state)[0].device), None)
        self.batches = self.warm = self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(env=None, device="cuda", **kw) -> dict:
    """The benchmark at the knobs of ``env`` (``Bench``'s ``cfg``,
    ``tile`` and ``state`` in ``kw``): prints the readings and the
    script's line; returns the readings with the line under ``line``."""
    bench = Bench(env, device, **kw)
    try:
        res = bench.measure()
    finally:
        bench.close()
    line = res.pop("line")
    emit(res)
    emit(line)
    return dict(res, line=line)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Tile-inference throughput (knobs: BENCH_PROFILE, "
                    "BENCH_BATCH, BENCH_STEPS, BENCH_TOPK, BENCH_INT8, "
                    "BENCH_INT8_SCOPE, BENCH_INT8_PYR, BENCH_SCANK).")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
