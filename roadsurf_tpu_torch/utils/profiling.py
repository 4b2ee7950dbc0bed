"""Tracing and stage timing (the reference package's ``utils/profiling.py``).

* :class:`StageTimer`: named wall-clock stages with item counters and a
  report of items/s (a copy of the reference's);
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (host and, on CUDA, device activity) of any block, where
  the reference wraps ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulating named stage timer.

    >>> t = StageTimer()
    >>> with t.stage("fetch", items=64): ...
    >>> t.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.items: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.items[name] = self.items.get(name, 0) + items

    def report(self, log=logger) -> dict:
        out = {}
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            row = {"seconds": round(total, 3),
                   "calls": self.counts[name]}
            if self.items.get(name):
                row["items_per_sec"] = round(self.items[name] / total, 1)
            out[name] = row
            extra = (f", {row['items_per_sec']} items/s"
                     if "items_per_sec" in row else "")
            log.info(f"[stage] {name}: {total:.3f}s over "
                     f"{row['calls']} calls{extra}")
        return out


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace to
    ``log_dir/trace.json``; a no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")
