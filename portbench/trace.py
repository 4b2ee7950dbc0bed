"""The traced run: ``torch.profiler`` (CUPTI) over a stretch of the window,
reduced in memory to what the per-layer metrics read; no trace file is
written.

Spans: the harness opens ``record_function`` ranges around its own calls
into each layer (``portbench.feed``, ``engine.stage``, ``engine.dispatch``,
``engine.drain``, ``portbench.consume``) and one, ``portbench.window``,
around the traced stretch. The summary keeps, inside that stretch: the
device's busy time (the union of every kernel, copy and set), device time
by kernel name and by category, the launches of each category, and the
idle time between device operations by the innermost span that was open
on the host when each gap began.
"""

from __future__ import annotations

import torch

WINDOW = "portbench.window"


def category(name: str) -> str:
    """A kernel's category by its name. A frozen copy of
    ``chip_smoke.py::_category`` at commit
    3882033a3117a5eeb7cc5982f7f3c4eaa452742c, with one category added
    before "other": PyTorch's elementwise kernels (``elementwise`` in the
    name; copies among them stay "copy"). "nhwc" also catches cuDNN's
    layout kernels, counted as convs."""
    n = name.lower()
    for cat, keys in (("roi_align_backward", ("roi_align_backward",)),
                      ("roi_align", ("roi_align",)),
                      ("nms", ("nms",)),
                      ("conv", ("conv", "xmma", "implicit", "cudnn",
                                "nhwc", "winograd")),
                      ("gemm", ("gemm", "cutlass", "cublas", "matmul")),
                      ("sort/top-k", ("sort", "radix", "topk")),
                      ("copy", ("memcpy", "memset", "copy")),
                      ("elementwise", ("elementwise",))):
        if any(k in n for k in keys):
            return cat
    return "other"


class Span:
    """``with Span(name):`` a ``record_function`` range, only while a
    profiler is on (``on``)."""

    on = False

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if Span.on:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def wrap(obj, method: str, name: str):
    """Open span ``name`` around ``obj.method`` where ``obj`` has it."""
    fn = getattr(obj, method, None)
    if fn is None:
        return

    def spanned(*a, **k):
        with Span(name):
            return fn(*a, **k)

    setattr(obj, method, spanned)


class Tracer:
    """The profiler, started in set-up (its own start-up is slow), with
    the ``portbench.window`` range opened and closed around the traced
    stretch of dispatches; stopped and reduced once the engine has
    drained."""

    def __init__(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.acts = acts
        self.prof = None
        self.summary = None

    def start(self):
        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.start()
        Span.on = True
        self.win = None

    def begin(self):
        self.win = torch.profiler.record_function(WINDOW)
        self.win.__enter__()

    def end(self):
        if self.win is not None:
            self.win.__exit__(None, None, None)

    def stop(self):
        Span.on = False
        self.prof.stop()
        self.summary = summarize(self.prof.profiler.kineto_results.events())
        self.prof = None


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict | None:
    """Kineto events -> the traced stretch's readings, in seconds; None
    without a ``portbench.window`` range."""
    win = None
    spans, dev = [], []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name == WINDOW:
                win = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif e.is_user_annotation():
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name))
        elif not e.is_user_annotation():        # the spans' device copies
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if win is None:
        return None
    w0, w1 = win
    by_name: dict = {}
    by_cat: dict = {}
    launches: dict = {}
    clipped = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        d = (e - s) * 1e-9
        by_name[name] = by_name.get(name, 0.0) + d
        c = category(name)
        by_cat[c] = by_cat.get(c, 0.0) + d
        launches[c] = launches.get(c, 0) + 1
    busy = _union(clipped)
    gaps = []
    t = w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    spans.sort()
    idle: dict = {}
    j = 0
    open_: list = []
    for g0, g1 in gaps:
        while j < len(spans) and spans[j][0] <= g0:
            open_.append(spans[j])
            j += 1
        open_ = [sp for sp in open_ if sp[1] > g0]
        label = max(open_)[2] if open_ else "host.other"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "by_category": by_cat, "launches": launches,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])}


def traced_tiles(ctx) -> float | None:
    """Tiles forwarded in the traced stretch: pooler launches (two a
    forward, the box and the mask pooler) over two, times the batch."""
    t = ctx.trace
    n = t["launches"].get("roi_align", 0) if t is not None else 0
    return n / 2 * ctx.batch if n else None


def per_tile_us(ctx, cat: str) -> float | None:
    """Device us a tile in kernels of category ``cat``."""
    n = traced_tiles(ctx)
    if n is None or cat not in ctx.trace["by_category"]:
        return None
    return ctx.trace["by_category"][cat] / n * 1e6
