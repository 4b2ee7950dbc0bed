"""CUDA graphs of the multi-batch dispatch: k forwards or k training steps
captured once and replayed with one host call.

The counterpart of the reference's ``lax.map`` and ``lax.scan`` inside
one dispatch (``make_inference_scan_fn``, ``make_train_scan_step``, the
engine's ``scan_k``). A :class:`CapturedGraph`:

* warms up first, on a side stream: one call of ``warm`` builds the
  kernels at first use (nvcc), lets cuDNN choose its algorithms, fills
  the caching allocator and makes the device constants
  (``utils.device.device_constant``); a second call runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so a host synchronisation
  left in the region raises here, named, and not as a failed capture;
* captures ``body`` on a stream of its own into a private memory pool;
  a failed capture raises (no caller falls back to the eager path);
* keeps the kernel launches of the captured region. The wrappers'
  counters (``ops.launch_counts``) tick while the region is captured,
  though no kernel runs then: the capture takes those ticks back, and
  every :meth:`~CapturedGraph.replay` adds them once, so the counts say
  what ran.

``capture_s`` (host seconds of the capture) and ``pool_bytes`` (device
memory the capture reserved: its pool) are the readings ``chip_smoke.py``
reports; ``CapturedGraph.captures`` counts the captures a process made.
The warm-ups and the capture are the span ``graph.capture``, a replay the
span ``graph.replay`` (``utils.profiling.span``): a trace sees the
replay's kernels, one launch, under no stage of the forward.
"""

from __future__ import annotations

import time

import torch

from ..ops import add_launch_counts, launch_counts
from .profiling import span


def tensor_leaves(tree) -> list:
    """Every tensor of a tree of dicts, lists and tuples, in its order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


def storage_key(tree) -> tuple:
    """The device addresses of a tree's tensors: a graph captured on the
    tree reads and writes those, so another key needs another capture."""
    return tuple(t.data_ptr() for t in tensor_leaves(tree))


class CapturedGraph:
    """``body()`` captured into a CUDA graph on ``device`` after ``warm()``
    ran twice on a side stream (the second time with host synchronisation
    an error). ``outputs`` is what ``body`` returned: static tensors that
    every :meth:`replay` writes anew."""

    captures = 0

    @span("graph.capture")
    def __init__(self, body, warm, device: torch.device):
        CapturedGraph.captures += 1
        self.device = device
        with torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                warm()
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    warm()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            current.wait_stream(side)
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            before = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(self.graph,
                                      stream=torch.cuda.Stream(device)):
                    self.outputs = body()
            finally:
                after = launch_counts()
                # the capture launched nothing: take its ticks back
                add_launch_counts({k: before[k] - after[k] for k in after})
            torch.cuda.synchronize(device)
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}

    @span("graph.replay")
    def replay(self):
        """One launch of the whole graph on the current stream; adds the
        captured region's kernel launches to the counters."""
        self.graph.replay()
        add_launch_counts(self.launches)
