"""Tracing (the reference package's ``utils/profiling.py``).

* :class:`span`: a named range in the profiler's trace, opened only while
  a profiler is on. The forward's stages (``forward.*``), the engine's
  steps (``engine.*``) and the CUDA graph's capture and replay
  (``graph.*``) are spans, so a trace of any block splits device time
  and the device's idle gaps by the host step that launched the work.
  Where the reference times stages on the wall clock (``StageTimer``),
  the port names them in the trace, on the clock of the device's events;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (host and, on CUDA, device activity) of any block, spans
  included, where the reference wraps ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

logger = logging.getLogger(__name__)

_profiler_on = torch._C._autograd._profiler_enabled


class span(contextlib.ContextDecorator):
    """``with span("forward.backbone"):``, or ``@span(...)`` on a
    function: a ``record_function`` range while a profiler records;
    otherwise one C-level check and nothing else (a range entered with no
    profiler costs ~100× the check)."""

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def _recreate_cm(self):
        return span(self.name)       # a call of its own, reentrant

    def __enter__(self):
        if _profiler_on():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace, with
    the program's spans, to ``log_dir/trace.json``; a no-op when
    ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
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
