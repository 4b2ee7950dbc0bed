"""One run of one cell: set-up, warm-up, the measured window through
``TileInferenceEngine.run``, the check against the plain reference, and
the metrics. The cell's model family (``spec.family``) gives the weights,
the class pin, the reference and the work counts; the tiles are the same
seeded uint8 tiles for every family. ``run.py`` is the command; the tests
drive :func:`run_cell` on the CPU.

The window is a closed loop: the feeding iterator hands the engine the
pool's batches in turn (the engine's own ``in_flight`` keeps that many
dispatches queued) until ``seconds`` have passed since the first hand-over,
stopping at a dispatch's boundary so that no group is padded; the engine
then drains, and the window closes when it yields the last result.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from . import check, modelgen, spec, work
from .trace import Span, Tracer, wrap
from .window import Window

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cfg_file: dict, settings: dict):
    """The program's ``ModelConfig`` from the configuration's constructor
    and arguments, with any setting the file changes; raises where one of
    its fields differs from the file's ``settings``, which the reference
    follows."""
    from roadsurf_tpu_torch.models import config as mc

    m = cfg_file["model"]
    cfg = getattr(mc, m["constructor"])(**m.get("args", {}))
    names = {f.name for f in fields(cfg)}
    cfg = replace(cfg, **{k: tuple(v) if isinstance(v, list) else v
                          for k, v in settings.items() if k in names})

    def norm(v):
        return [float(x) for x in v] if isinstance(v, (list, tuple)) else v

    bad = [k for k in settings if k in names
           and norm(getattr(cfg, k)) != norm(settings[k])]
    if bad:
        raise ValueError(f"the program's config differs on {bad}")
    return cfg


class Sampler:
    """A reservoir of ``k`` of the window's returned tiles, drawn from the
    seed: each tile's rows of every output, and its pool index."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.seen = 0
        self.rows: list = []

    def offer(self, dets: dict, pool_idx: np.ndarray):
        n = len(pool_idx)
        pos = self.seen + np.arange(n)
        slot = np.floor(self.rng.random(n) * (pos + 1)).astype(np.int64)
        self.seen += n
        for r in range(n):
            s = int(slot[r]) if pos[r] >= self.k else int(pos[r])
            if s >= self.k:
                continue
            row = {key: np.array(v[r]) for key, v in dets.items()}
            row["pool"] = int(pool_idx[r])
            if s < len(self.rows):
                self.rows[s] = row
            else:
                self.rows.append(row)


class Work:
    """``ctx.work``: the counts of the cell's family (``forward_flops``,
    ``pooler_bytes``, ``nms_bytes`` and any it adds for its own kernels)
    beside the card's peaks of ``work.py``."""

    BF16_PEAK = work.BF16_PEAK
    HBM_BYTES_PER_S = work.HBM_BYTES_PER_S

    def __init__(self, family):
        self.family = family

    def __getattr__(self, name):
        return getattr(self.family, name)


@dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    window: Window
    setup_s: float
    stats: dict             # the engine's stats over the window
    dispatches: int
    batch: int
    tile_px: int
    settings: dict
    precision: str
    capture_s: float | None
    trace: dict | None
    work: Work


def _feed(pool, order, B, k, seconds, win: Window, tracer, trace_at,
          hand_idx: list):
    """The window's batches: the pool's in ``order``, each hand-over
    timed, until ``seconds`` after the first, at a dispatch boundary; a
    traced run ends its window with the traced stretch, dispatches
    ``trace_at[0]`` to ``trace_at[1]``."""
    nb = len(order)
    i = 0
    t_first = None
    while True:
        if i % k == 0:
            d = i // k
            if t_first is not None and time.perf_counter() - t_first \
                    >= seconds:
                return
            if tracer is not None:
                if d == trace_at[0]:
                    tracer.begin()
                elif d == trace_at[1]:
                    tracer.end()
                    return
        with Span("portbench.feed"):
            b = order[i % nb]
            batch = pool[b * B:(b + 1) * B]
            hand_idx.append(np.arange(b * B, (b + 1) * B))
        t = time.perf_counter()
        t_first = t if t_first is None else t_first
        win.hand(t, len(batch))
        yield batch
        i += 1


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t0: float, device="cuda", overrides: dict | None = None,
             prepare=None) -> dict:
    """One run -> {correct, attempted, failed, metrics, device,
    [breakdown], readings, checks}. ``overrides``: {"settings": {...},
    "traffic": {...}, "precision": ...}, with which the tests run narrow
    and small; ``prepare(cfg, state, pool, device) -> (cfg, state)`` puts
    another path of the program in its place (the control)."""
    from roadsurf_tpu_torch.engine.infer import TileInferenceEngine

    ov = overrides or {}
    settings = dict(cell.config["settings"], **ov.get("settings", {}))
    traffic = dict(cell.traffic, **ov.get("traffic", {}))
    precision = ov.get("precision", cell.config["precision"])
    limits = cell.config["limits"]
    cfg = port_config(cell.config, settings)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    B, k, px = traffic["batch"], traffic["scan_k"], traffic["tile_px"]
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    family = cell.family
    g = modelgen.generator(seed, dev)
    state = family.weights(settings, g, dev, DTYPES[precision])
    pool = modelgen.tiles(traffic["pool_tiles"], px, g, dev)
    family.pin_classes(state, settings, pool[:family.PIN_TILES], dev)
    if prepare is not None:
        cfg, state = prepare(cfg, state, pool, dev)
    eng = TileInferenceEngine(state, cfg, batch_size=B,
                              mask_format=traffic["mask_format"],
                              device=dev, scan_k=k)
    nb = traffic["pool_tiles"] // B
    warm = (eng.in_flight + 1) * k
    for _ in eng.run(pool[(i % nb) * B:(i % nb + 1) * B]
                     for i in range(warm)):
        pass
    if cuda:
        torch.cuda.synchronize(dev)
    stats0 = dict(eng.stats)
    tracer = Tracer(cuda) if trace else None
    if tracer is not None:
        for name, span in (("_stage", "engine.stage"),
                           ("_stage_group", "engine.stage"),
                           ("_dispatch", "engine.dispatch"),
                           ("_dispatch_group", "engine.dispatch"),
                           ("_drain", "engine.drain"),
                           ("_drain_group", "engine.drain")):
            wrap(eng, name, span)
        tracer.start()
    first = eng.in_flight + 1
    trace_at = (first, first + traffic["trace_dispatches"])
    order = [(warm + i) % nb for i in range(nb)]
    rng = np.random.default_rng([int(seed) % 2 ** 63, 1])
    sampler = Sampler(traffic["check_tiles"], rng)
    win, hand_idx = Window(), []
    setup_s = None
    feeder = _feed(pool, order, B, k, seconds, win, tracer, trace_at,
                   hand_idx)
    for j, dets in enumerate(eng.run(feeder)):
        t = time.perf_counter()
        with Span("portbench.consume"):
            n = len(dets["scores"])
            win.result(t, n)
            sampler.offer(dets, hand_idx[j][:n])
        if setup_s is None:
            setup_s = win.handed[0][0] - t0
    if tracer is not None:
        tracer.end()
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stats = {key: eng.stats[key] - stats0.get(key, 0.0) for key in eng.stats}
    graph = getattr(eng.replicas[0], "graph", None)
    capture_s = getattr(graph, "capture_s", None)
    dispatches = -(-len(win.handed) // k)
    del eng, graph
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rows = sampler.rows
    t_check = time.perf_counter()
    images = torch.from_numpy(pool[[r["pool"] for r in rows]]).to(dev)
    ref = family.run(state, images, settings, check.given_boxes(rows, dev),
                     block=traffic["check_block"])
    values = check.readings(rows, ref, settings["score_thresh_test"],
                            settings["detections_per_image"])
    values["check_s"] = time.perf_counter() - t_check
    correct, shown = check.verdict(values, limits, win.tiles, win.attempted)
    ctx = Context(window=win, setup_s=setup_s, stats=stats,
                  dispatches=dispatches, batch=B, tile_px=px,
                  settings=settings, precision=precision,
                  capture_s=capture_s,
                  trace=tracer.summary if tracer is not None else None,
                  work=Work(family))
    chosen = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in chosen:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.attempted - win.tiles, "metrics": metrics,
           "device": device_info}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace["busy_s"]
        device_info["window_s"] = ctx.trace["window_s"]
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           ctx.trace["device_ops"][:10]],
                            "idle_gaps": [list(x) for x in
                                          ctx.trace["idle_gaps"][:10]]}
    out["readings"] = values
    out["checks"] = shown
    return out
