"""Tile-inference engine: the throughput-critical loop, on one device or
sharded over several.

Port of the reference's ``TileInferenceEngine`` (engine/infer.py there),
its scan-k dispatch included. One pipeline runs every case: a dispatch is
a group of ``scan_k`` padded batches (one batch at ``scan_k=1``).

* ``run`` zero-pads each batch to the batch size (trimmed after), stages
  it into its group's host slot, dispatches the group once it holds
  ``scan_k`` batches, and fetches a group's result only once ``in_flight``
  newer groups are queued behind it, so host decode and result handling
  overlap device compute. The tail group is padded with zero batches of
  ``n = 0``, dropped after the fetch. The batches of a group have one
  tile size; the next group may take another;
* ``devices=[...]``, the counterpart of the reference's ``devices=`` and
  its ``("data",)`` mesh: one replica of the state a device, each batch
  split into contiguous shards (rows ``[r·b, (r+1)·b)`` on device r, as
  ``P("data")`` places them), and the packed outputs gathered in row
  order into one host buffer. A batch size the devices do not divide
  runs on the first device, as in the reference. Two entries may name
  one device (two replicas, two streams);
* a dispatch, on each replica's side CUDA stream: one host-to-device copy
  of its pinned (k, shard, H, W, 3) slot; the group's forwards, every
  output (boxes/scores/classes/valid/masks) viewed as bytes and
  concatenated into ONE (shard, bytes) uint8 buffer on the device; one
  device-to-host copy of the packed (k, shard, bytes) result into the
  replica's rows of a pinned (replicas, k, shard, bytes) host buffer; one
  event. On CUDA at ``scan_k`` > 1 the forwards are one replay of a CUDA
  graph of ``scan_k`` packed forwards (``models.mask_rcnn.capture_scan``,
  captured at the replica's first group; a failed capture raises), else
  they run eagerly. On the CPU (``device="cpu"``) the same loop runs
  synchronously, with no stream and no event;
* the drain waits on a group's events and unpacks each batch from the
  host buffer with numpy views;
* ``stats`` keeps the host's seconds in each step: ``h2d_s`` (staging +
  issuing the upload), ``d2h_s`` (waiting for a group's result) and
  ``unpack_s`` (copying it out of the pinned buffer into the caller's
  arrays), beside ``tiles_seen``. The steps are also spans
  (``utils.profiling.span``: ``engine.stage``, ``engine.dispatch``,
  ``engine.drain``, ``engine.unpack``), which a profiler's trace shows
  beside the forward's stages and the device's work;
* :meth:`~TileInferenceEngine.load_state` gives a built engine new
  weights of the same layout, so that a caller keeps one engine, its
  pinned buffers and its captured graphs across calls (the reference's
  compiled function outlives a call through its ``lru_cache``;
  ``pipeline.detections.detect_tiles`` keeps engines so).

``prefetch_iter`` (the reference's) runs a producer, such as the tile
decode of ``pipeline/detections.py``, in a thread ahead of the engine.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import queue as _queue
import threading
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.mask_rcnn import capture_scan, check_config, \
    forward_prepared, prepare_state
from ..utils.device import resolve_device
from ..utils.graphs import tensor_leaves
from ..utils.profiling import span

logger = logging.getLogger(__name__)


def _pack(dets: dict) -> tuple[torch.Tensor, list]:
    """dets -> (one (B, bytes) uint8 tensor, meta); outputs in sorted-key
    order, bool as uint8, every other dtype viewed as its bytes. meta rows
    are (key, numpy dtype, trailing shape, byte offset, byte length)."""
    parts, meta, off = [], [], 0
    for k in sorted(dets):
        v = dets[k].contiguous()
        dt = np.bool_ if v.dtype == torch.bool else \
            torch.empty((), dtype=v.dtype).numpy().dtype
        if v.dtype == torch.bool:
            v = v.to(torch.uint8)
        b = v.reshape(v.shape[0], -1).view(torch.uint8)
        meta.append((k, np.dtype(dt), tuple(v.shape[1:]), off, b.shape[1]))
        off += b.shape[1]
        parts.append(b)
    return torch.cat(parts, dim=1), meta


def _unpack(buf: np.ndarray, meta: list, n: int) -> dict:
    """One packed (B, bytes) host buffer -> dict of arrays, trimmed to n.
    Every array is a copy: the pinned buffer is reused by a later batch,
    while a consumer (the detection host stage's pool) may still hold this
    batch's dict."""
    out = {}
    for k, dt, shape, off, nbytes in meta:
        raw = np.array(buf[:n, off:off + nbytes])
        out[k] = raw.view(dt).reshape((n,) + shape)
    return out


def prefetch_iter(it, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue so the
    producer (e.g. tile decode) overlaps the consumer (device dispatch).
    An exception of the producer is raised in the consumer."""
    q = _queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:         # surface in the consumer
            q.put(e)
            return
        q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _layout(tree):
    """A state tree's keys, each tensor's shape, dtype and strides, and
    every other leaf's value: what a captured graph bakes in besides the
    tensors' contents."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype, tree.stride()
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_layout(v) for v in tree)
    return tree


def _private(tree):
    """Copies of a state tree's tensors, owned by the engine: a graph
    captured on them keeps reading them, and new weights are copied into
    them, never into a caller's tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _private(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_private(v) for v in tree]
    return tree


class _Replica:
    """One device's copy of the state, its side stream and its pinned
    input slots."""

    def __init__(self, state: dict, device: torch.device, cfg: ModelConfig,
                 slots: int):
        self.device = device
        self.state = prepare_state(state, cfg, device)
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.in_bufs: list = [None] * slots
        self.graph = None           # the scan-k graph (CUDA, scan_k > 1)


class TileInferenceEngine:
    """Batched, pipelined detector inference on one device, or sharded over
    ``devices``.

    >>> eng = TileInferenceEngine(state, cfg, batch_size=64, scan_k=16)
    >>> for dets in eng.run(tile_iterator):  # dicts of numpy arrays
    ...     consume(dets)
    """

    def __init__(self, state: dict, cfg: ModelConfig, batch_size: int = 64,
                 with_masks: bool = True, in_flight: int = 2,
                 mask_format: str = "logits", device="cuda",
                 devices=None, scan_k: int = 1):
        devices = [resolve_device(d) for d in (devices or [device])]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"devices of one type expected: {devices}")
        if len(devices) > 1 and batch_size % len(devices):
            logger.warning(f"batch {batch_size} does not split over "
                           f"{len(devices)} devices; running on "
                           f"{devices[0]} alone")
            devices = devices[:1]
        self.device = devices[0]
        check_config(cfg, mask_format)
        self.cfg = cfg
        self.batch_size = batch_size
        self.in_flight = max(1, in_flight)
        self.scan_k = max(1, int(scan_k))
        self.with_masks = with_masks
        self.mask_format = mask_format
        self.cuda = self.device.type == "cuda"
        # in_flight + 1 pinned slots: a slot is reused only after the group
        # that last used it was drained (its events waited on)
        self._slots = self.in_flight + 1
        self.replicas = [_Replica(state, d, cfg, self._slots)
                         for d in devices]
        self.state = self.replicas[0].state
        self.shard = batch_size // len(devices)
        if len(devices) > 1:
            logger.info(f"inference shards: {len(devices)} devices, batch "
                        f"{batch_size} ({self.shard} a device)")
        self._out_bufs: list = [None] * self._slots
        self._n_dispatched = 0
        self.tiles_seen = 0
        self.stats = {"h2d_s": 0.0, "d2h_s": 0.0, "unpack_s": 0.0}

    @contextlib.contextmanager
    def _timed(self, name: str, key: str):
        """Span ``name`` around the block, whose host seconds add to
        ``stats[key]``."""
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.stats[key] += time.perf_counter() - t0

    def load_state(self, state: dict):
        """Run the next batches on ``state``'s weights. A replica with a
        captured graph copies them into its own tensors, the addresses the
        graph reads, where the tree has the layout it was captured on
        (:func:`_layout`: the same shapes, types and strides, the same
        non-tensor values); otherwise the replica takes the placed state
        and drops its graph, which its next group captures anew. A graph
        never replays the previous weights."""
        for rep in self.replicas:
            placed = prepare_state(state, self.cfg, rep.device)
            if rep.graph is not None and _layout(placed) == _layout(
                    rep.state):
                with torch.inference_mode():
                    for d, s in zip(tensor_leaves(rep.state),
                                    tensor_leaves(placed)):
                        d.copy_(s, non_blocking=True)
            else:
                rep.state, rep.graph = placed, None
        self.state = self.replicas[0].state

    def _stage(self, slot: int, i: int, images: np.ndarray):
        """Batch i of the group in ``slot``: each replica's rows into its
        (k, shard, H, W, 3) host buffer, pinned on CUDA. A group's first
        batch may bring a new tile size (a new buffer), the others not."""
        b = self.shard
        shape = (self.scan_k, b) + images.shape[1:]
        with self._timed("engine.stage", "h2d_s"):
            for r, rep in enumerate(self.replicas):
                buf = rep.in_bufs[slot]
                if buf is None or buf.shape != shape:
                    if i:
                        raise ValueError(f"tiles of {images.shape[1:]} in "
                                         f"a group of "
                                         f"{tuple(buf.shape[2:])}")
                    buf = torch.empty(shape, dtype=torch.uint8,
                                      pin_memory=self.cuda)
                    rep.in_bufs[slot] = buf
                buf.numpy()[i] = images[r * b:(r + 1) * b]

    @span("engine.dispatch")
    def _dispatch(self, slot: int, ns: list):
        """Run the group staged in ``slot`` on every replica: upload its
        rows, run the group's forwards (on CUDA at ``scan_k`` > 1, a
        replay of the replica's graph of them) and fetch the packed
        result with one copy; -> (host (replicas, k, shard, bytes) buffer,
        meta, ns, events)."""
        self._n_dispatched += 1
        host = self._out_bufs[slot]
        done = []
        for r, rep in enumerate(self.replicas):
            with contextlib.ExitStack() as ctx:
                ctx.enter_context(torch.inference_mode())
                if self.cuda:
                    # the side stream waits for work queued before it (the
                    # weights' upload, a caller's tensors); the replica's
                    # event is recorded after its fetch, as the block ends
                    rep.stream.wait_stream(
                        torch.cuda.current_stream(rep.device))
                    ctx.enter_context(torch.cuda.device(rep.device))
                    ctx.enter_context(torch.cuda.stream(rep.stream))
                    done.append(torch.cuda.Event())
                    ctx.callback(done[-1].record, rep.stream)
                staged = rep.in_bufs[slot]
                if self.cuda and self.scan_k > 1:
                    graph = self._scan_graph(rep, tuple(staged.shape))
                    with self._timed("engine.stage", "h2d_s"):
                        graph.static_in.copy_(staged, non_blocking=True)
                    graph.replay()
                    out, meta = graph.outputs["packed"], graph.meta
                else:
                    with self._timed("engine.stage", "h2d_s"):
                        x = staged.to(rep.device, non_blocking=True)
                    packed, metas = zip(*(_pack(self._forward(rep, xi))
                                          for xi in x))
                    meta = metas[0]
                    # one batch (every eager group on CUDA) is viewed as
                    # (1, shard, bytes): no device copy
                    out = torch.stack(packed) if len(packed) > 1 \
                        else packed[0][None]
                shape = (len(self.replicas),) + tuple(out.shape)
                if host is None or tuple(host.shape) != shape:
                    host = torch.empty(shape, dtype=torch.uint8,
                                       pin_memory=self.cuda)
                    self._out_bufs[slot] = host
                # ONE device-to-host copy a replica, into its rows
                host[r].copy_(out, non_blocking=True)
        return host.numpy(), meta, ns, done

    def _forward(self, rep: _Replica, x: torch.Tensor) -> dict:
        return forward_prepared(rep.state, x, self.cfg, self.with_masks,
                                self.mask_format)

    def _drain(self, item) -> list:
        buf, meta, ns, done = item
        with self._timed("engine.drain", "d2h_s"):
            for ev in done:
                ev.synchronize()
        out = []
        with self._timed("engine.unpack", "unpack_s"):
            for i, n in enumerate(ns):
                if n:                   # the tail group's empty batches go
                    self.tiles_seen += n
                    # a view where one replica (or one batch) holds the rows
                    out.append(_unpack(buf[:, i].reshape(-1, buf.shape[-1]),
                                       meta, n))
        return out

    def _padded(self, images) -> tuple[np.ndarray, int]:
        images = np.asarray(images, np.uint8)
        n = images.shape[0]
        if not 0 < n <= self.batch_size:
            raise ValueError(f"batch of {n} tiles; 1..{self.batch_size}"
                             " expected")
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n,) + images.shape[1:],
                           np.uint8)
            images = np.concatenate([images, pad])
        return images, n

    def _scan_graph(self, rep: _Replica, shape: tuple):
        """The replica's graph of ``scan_k`` packed forwards at ``shape``,
        captured at its first group (and again if the tiles' size
        changes); ``graph.meta`` unpacks its rows."""
        if rep.graph is None or tuple(rep.graph.static_in.shape) != shape:
            rep.graph = None            # its pool goes before the next
            # the graph reads the engine's own copy of the weights
            # (load_state copies new ones into it)
            rep.state = _private(rep.state)
            if rep is self.replicas[0]:
                self.state = rep.state
            meta = []

            def per_slice(x):
                packed, meta[:] = _pack(self._forward(rep, x))
                return {"packed": packed}

            rep.graph = capture_scan(per_slice, shape, rep.device)
            rep.graph.meta = meta
        return rep.graph

    def run(self, image_iter):
        """Consume an iterator of (B', H, W, 3) uint8 arrays (B' ≤ batch
        size; the tail batch is padded and trimmed transparently); yields
        per-batch dicts of numpy detection arrays."""
        queue = collections.deque()
        ns: list = []
        for images in image_iter:
            images, n = self._padded(images)
            slot = self._n_dispatched % self._slots
            self._stage(slot, len(ns), images)
            ns.append(n)
            if len(ns) == self.scan_k:
                queue.append(self._dispatch(slot, ns))
                ns = []
                while len(queue) > self.in_flight:
                    yield from self._drain(queue.popleft())
        if ns:                          # tail: pad to k empty batches
            zeros = np.zeros((self.batch_size,) + images.shape[1:],
                             np.uint8)
            while len(ns) < self.scan_k:
                self._stage(slot, len(ns), zeros)
                ns.append(0)
            queue.append(self._dispatch(slot, ns))
        while queue:
            yield from self._drain(queue.popleft())
