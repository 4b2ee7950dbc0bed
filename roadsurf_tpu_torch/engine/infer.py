"""Tile-inference engine for one GPU: the throughput-critical loop.

Port of the reference's ``TileInferenceEngine`` (engine/infer.py there)
without its device mesh and its scan-k dispatch:

* a lag-``in_flight`` pipeline: each batch is uploaded from a pinned host
  buffer and run on a side CUDA stream, and its result is fetched only
  once ``in_flight`` newer batches are queued behind it, so host decode
  and result handling overlap device compute;
* a packed fetch: every output (boxes/scores/classes/valid/masks) is
  viewed as bytes and concatenated into ONE (B, bytes) uint8 buffer on
  the device, copied with a single device->host transfer into a pinned
  buffer, and unpacked on the host with numpy views;
* the tail batch is zero-padded to the batch size and trimmed after;
* ``stats`` keeps the host's waits: ``h2d_s`` (staging + issuing the
  upload) and ``d2h_s`` (waiting for a batch's result), beside
  ``tiles_seen`` and ``elapsed``.

On the CPU (``device="cpu"``) the same loop runs synchronously.
``prefetch_iter`` (the reference's) runs a producer, such as the tile
decode of ``pipeline/detections.py``, in a thread ahead of the engine.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.mask_rcnn import check_config, forward_prepared
from ..utils.device import compute_dtype, resolve_device
from ..utils.weights import state_to


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


class TileInferenceEngine:
    """Batched, pipelined detector inference on one device.

    >>> eng = TileInferenceEngine(state, cfg, batch_size=64)
    >>> for dets in eng.run(tile_iterator):  # dicts of numpy arrays
    ...     consume(dets)
    """

    def __init__(self, state: dict, cfg: ModelConfig, batch_size: int = 64,
                 with_masks: bool = True, in_flight: int = 2,
                 mask_format: str = "logits", device="cuda"):
        self.device = resolve_device(device)
        check_config(cfg, mask_format)
        self.cfg = cfg
        self.batch_size = batch_size
        self.in_flight = max(1, in_flight)
        self.with_masks = with_masks
        self.mask_format = mask_format
        self.state = state_to(state, self.device, compute_dtype(cfg))
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        # in_flight + 1 pinned slots: a slot is reused only after the batch
        # that last used it was drained (its event waited on)
        self._slots = self.in_flight + 1
        self._in_bufs: list = [None] * self._slots
        self._out_bufs: list = [None] * self._slots
        self._n_dispatched = 0
        self.tiles_seen = 0
        self.elapsed = 0.0
        self.stats = {"h2d_s": 0.0, "d2h_s": 0.0}

    def _stage(self, slot: int, images: np.ndarray) -> torch.Tensor:
        """Host images -> device tensor (on CUDA: a pinned staging buffer
        and an async copy on the current stream, the engine's side
        stream)."""
        t0 = time.perf_counter()
        if not self.cuda:
            x = torch.from_numpy(images)
        else:
            buf = self._in_bufs[slot]
            if buf is None or buf.shape != images.shape:
                buf = torch.empty(images.shape, dtype=torch.uint8,
                                  pin_memory=True)
                self._in_bufs[slot] = buf
            buf.numpy()[...] = images
            x = buf.to(self.device, non_blocking=True)
        self.stats["h2d_s"] += time.perf_counter() - t0
        return x

    def _dispatch(self, images: np.ndarray, n: int):
        slot = self._n_dispatched % self._slots
        self._n_dispatched += 1
        if not self.cuda:
            with torch.inference_mode():
                packed, meta = _pack(self._forward(
                    self._stage(slot, images)))
            return packed.numpy(), meta, n, None
        # the side stream waits for work queued before it (the weights'
        # upload, a caller's tensors)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode(), torch.cuda.stream(self.stream):
            packed, meta = _pack(self._forward(self._stage(slot, images)))
            host = self._out_bufs[slot]
            if host is None or host.shape != packed.shape:
                host = torch.empty(packed.shape, dtype=torch.uint8,
                                   pin_memory=True)
                self._out_bufs[slot] = host
            host.copy_(packed, non_blocking=True)        # ONE d2h copy
            done = torch.cuda.Event()
            done.record(self.stream)
        return host.numpy(), meta, n, done

    def _forward(self, x: torch.Tensor) -> dict:
        return forward_prepared(self.state, x, self.cfg, self.with_masks,
                                self.mask_format)

    def _drain(self, item) -> dict:
        buf, meta, n, done = item
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        self.stats["d2h_s"] += time.perf_counter() - t0
        self.tiles_seen += n
        return _unpack(buf, meta, n)

    def run(self, image_iter):
        """Consume an iterator of (B', H, W, 3) uint8 arrays (B' ≤ batch
        size; the tail batch is padded and trimmed transparently); yields
        per-batch dicts of numpy detection arrays."""
        queue = collections.deque()
        t0 = time.perf_counter()
        for images in image_iter:
            images = np.asarray(images, np.uint8)
            n = images.shape[0]
            if not 0 < n <= self.batch_size:
                raise ValueError(f"batch of {n} tiles; 1..{self.batch_size}"
                                 " expected")
            if n < self.batch_size:
                pad = np.zeros((self.batch_size - n,) + images.shape[1:],
                               np.uint8)
                images = np.concatenate([images, pad])
            queue.append(self._dispatch(images, n))
            while len(queue) > self.in_flight:
                yield self._drain(queue.popleft())
        while queue:
            yield self._drain(queue.popleft())
        self.elapsed += time.perf_counter() - t0
