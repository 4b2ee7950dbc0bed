"""Device time by stage of the forward, from a traced run.

The program names its forward's stages with ``record_function`` ranges
(``roadsurf_tpu_torch.utils.profiling.span``): ``forward.preprocess``,
``.backbone``, ``.fpn``, ``.rpn``, ``.box_head``, ``.mask_head``.
:func:`by_stage` puts each device operation of the traced stretch (a
kernel, copy or set, clipped to the ``portbench.window`` range) down to
the innermost of those spans open on the host thread that launched it:
kineto links a device operation to the host op that launched it
(``linked_correlation_id`` of the one, ``correlation_id`` of the other),
and that op's start lies inside the span. An operation launched outside
every ``forward.*`` span gets no stage: the uploads, the packed fetch,
and each kernel of a CUDA graph's replay, which one ``cudaGraphLaunch``
launches.

``trace.Tracer`` keeps no events past its reduction, so the benchmark's
own traced runs do not read this. The command runs a cell traced,
through ``harness.run_cell``, with :class:`StageTracer` in the Tracer's
place:

    python3 -m portbench.stages --workload <cell> --seeds 1,2,3

and prints a JSON line a seed: the per-layer metrics of the run, the
traced stretch's tiles, seconds and tiles/s, the device's busy µs a
tile, each stage's device µs a tile, their sum's share of the busy time,
and the idle gaps by the innermost span open when each began.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
from types import SimpleNamespace

import torch

from .trace import WINDOW, Tracer, traced_tiles

STAGES = ("forward.preprocess", "forward.backbone", "forward.fpn",
          "forward.rpn", "forward.box_head", "forward.mask_head")


def by_stage(events) -> dict | None:
    """Kineto events -> {stage: device seconds inside the traced
    stretch}; None without a ``portbench.window`` range."""
    cpu = torch.autograd.DeviceType.CPU
    win = None
    launched: dict = {}         # host op's correlation id -> (thread, ns)
    spans: dict = {}            # thread -> [(start, end, stage)]
    dev = []
    for e in events:
        s = e.start_ns()
        if e.device_type() == cpu:
            name = e.name()
            if name == WINDOW:
                win = (s, s + e.duration_ns())
            elif name in STAGES and e.is_user_annotation():
                spans.setdefault(e.start_thread_id(), []).append(
                    (s, s + e.duration_ns(), name))
            if e.linked_correlation_id() == 0:
                launched[e.correlation_id()] = (e.start_thread_id(), s)
        elif not e.is_user_annotation():        # the spans' device copies
            dev.append((s, s + e.duration_ns(), e.linked_correlation_id()))
    if win is None:
        return None
    starts = {}
    for tid, sp in spans.items():
        sp.sort()
        starts[tid] = [x[0] for x in sp]
    w0, w1 = win
    out: dict = {}
    for s, e, corr in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s or corr not in launched:
            continue
        tid, t = launched[corr]
        # the stages do not nest: the last one to start at or before the
        # launch is the only one that can hold it
        i = bisect.bisect_right(starts.get(tid, []), t) - 1
        if i < 0 or t > spans[tid][i][1]:
            continue
        stage = spans[tid][i][2]
        out[stage] = out.get(stage, 0.0) + (e - s) * 1e-9
    return out


def stage_us(ctx, stage: str) -> float | None:
    """Device µs a tile in ``stage`` over the traced stretch, None where
    the trace has no time in it (``ctx``: a ``harness.Context``, or
    anything with its ``trace`` and ``batch``)."""
    n = traced_tiles(ctx)
    got = (ctx.trace or {}).get("by_stage") or {}
    if n is None or stage not in got:
        return None
    return got[stage] / n * 1e6


class StageTracer(Tracer):
    """``trace.Tracer`` whose summary also holds ``by_stage``."""

    def stop(self):
        prof = self.prof
        super().stop()
        if self.summary is not None:
            self.summary["by_stage"] = by_stage(
                prof.profiler.kineto_results.events())


def reading(res: dict, summary: dict, batch: int) -> dict:
    """One run's line: ``res`` from ``harness.run_cell``, the traced
    stretch's summary with ``by_stage``."""
    ctx = SimpleNamespace(trace=summary, batch=batch)
    n = traced_tiles(ctx)
    stages = {s: stage_us(ctx, s) for s in STAGES}
    staged = sum(v for v in stages.values() if v is not None)
    busy_us = summary["busy_s"] / n * 1e6 if n else None
    return {"correct": res["correct"], "metrics": {
        k: v["value"] for k, v in res["metrics"].items()},
        "traced_tiles": n, "window_s": summary["window_s"],
        "busy_s": summary["busy_s"],
        "traced_tiles_per_s": n / summary["window_s"] if n else None,
        "busy_us_per_tile": busy_us, "stage_us_per_tile": stages,
        "staged_share_of_busy": staged / busy_us if busy_us else None,
        "idle_gaps": summary["idle_gaps"],
        "device": res["device"]["kind"]}


def main(argv=None) -> int:
    import argparse

    from . import harness, spec
    from .run import caches

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated, one traced run each")
    args = ap.parse_args(argv)
    caches()
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    made: list = []

    def tracer(cuda):
        made.append(StageTracer(cuda))
        return made[-1]

    plain, harness.Tracer = harness.Tracer, tracer
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            res = harness.run_cell(cell, seed, bench["run_seconds"], True,
                                   time.perf_counter(), device="cuda:0")
            line = reading(res, made[-1].summary, cell.traffic["batch"])
            print(json.dumps(dict(line, workload=cell.name, seed=seed)),
                  flush=True)
    finally:
        harness.Tracer = plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
