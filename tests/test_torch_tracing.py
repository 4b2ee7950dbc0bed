"""The port's spans (``utils/profiling.py::span``) and what the benchmark
reads of them, on the CPU:

* the forward's stages: under a CPU ``torch.profiler`` every top-level
  ATen op of ``forward_prepared`` lies in exactly one ``forward.*`` span,
  and the stages come in order, on the float32, bf16, int8 and int8
  pyramid paths of a narrow fast and parity config;
* the engine's steps (``engine.stage``, ``.dispatch``, ``.drain``,
  ``.unpack``) at scan_k 1 and 2, and its ``stats["unpack_s"]``;
* with no profiler no span opens a ``record_function`` range;
* ``portbench/stages.py``: device time by stage on synthetic kineto
  events, and per tile on a synthetic context; ``portbench/metrics/
  engine.unpack_ms.py``.
"""

import importlib.util
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import stages, trace as ptrace
from roadsurf_tpu_torch.engine import TileInferenceEngine
from roadsurf_tpu_torch.models import fast_profile, init_params
from roadsurf_tpu_torch.models.config import ModelConfig
from roadsurf_tpu_torch.models.mask_rcnn import forward_prepared
from roadsurf_tpu_torch.models.quant import prepare_quantized
from roadsurf_tpu_torch.utils import profiling
from roadsurf_tpu_torch.utils.device import compute_dtype
from roadsurf_tpu_torch.utils.weights import from_jax_params, state_to

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("forward.preprocess", "forward.backbone", "forward.fpn",
          "forward.rpn", "forward.box_head", "forward.mask_head")
NARROW = {"fpn_channels": 32, "box_fc_dim": 64, "mask_conv_dim": 32}
PATHS = {"float32": {"compute_dtype": "float32"},
         "bfloat16": {"compute_dtype": "bfloat16"},
         "int8": {"compute_dtype": "float32", "int8_scope": "full"},
         "int8_pyramid": {"compute_dtype": "float32", "int8_scope": "full",
                          "int8_pyramid": True}}


def _config(profile_name: str, path: str):
    """(config, native tile size): the fast profile at 64 px native, or
    the parity profile resizing 64 -> 128 px, narrow, small budgets."""
    if profile_name == "fast":
        cfg = replace(fast_profile(post_nms_topk=32), min_size_test=64,
                      max_size_test=64, detections_per_image=4, **NARROW)
    else:
        cfg = replace(ModelConfig(), min_size_test=128, max_size_test=128,
                      rpn_pre_nms_topk_test=64, rpn_post_nms_topk_test=32,
                      detections_per_image=4, **NARROW)
    return replace(cfg, **PATHS[path]), 64


def _state(cfg, tiles):
    state = from_jax_params(init_params(cfg, torch.Generator().manual_seed(0)))
    if cfg.int8_scope:
        state["quant"] = prepare_quantized(state, tiles, cfg, device="cpu")
    return state


def _tiles(n: int, px: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, px, px, 3),
                                                np.uint8)


def _is_stage(ev) -> bool:
    return ev.name in STAGES


@pytest.mark.parametrize("profile_name,path", [
    ("fast", "float32"), ("fast", "bfloat16"), ("fast", "int8"),
    ("fast", "int8_pyramid"), ("parity", "float32"),
    ("parity", "int8_pyramid")])
def test_every_op_of_the_forward_lies_in_one_stage(profile_name, path):
    cfg, px = _config(profile_name, path)
    tiles = _tiles(2, px)
    state = state_to(_state(cfg, tiles), torch.device("cpu"),
                     compute_dtype(cfg))
    images = torch.from_numpy(tiles)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.forward"):
            out = forward_prepared(state, images, cfg, True, "bits")
    assert out["mask_bits"].dtype == torch.uint8
    events = prof.events()
    (top,) = [e for e in events if e.name == "test.forward"]
    order, ops = [], 0
    for ev in events:
        if ev.name.startswith("forward."):
            assert _is_stage(ev), ev.name
            chain = []
            p = ev.cpu_parent
            while p is not None:
                chain.append(p)
                p = p.cpu_parent
            assert top in chain and not any(map(_is_stage, chain)), ev.name
            order.append((ev.time_range.start, ev.name))
        if not ev.name.startswith("aten::"):
            continue
        chain = []
        p = ev.cpu_parent
        while p is not None:
            chain.append(p)
            p = p.cpu_parent
        if any(p.name.startswith("aten::") for p in chain):
            continue                    # inside another ATen op
        assert top in chain, ev.name
        assert sum(map(_is_stage, chain)) == 1, (ev.name,
                                                 [p.name for p in chain])
        ops += 1
    assert [n for _, n in sorted(order)] == list(STAGES)
    assert ops > 100


@pytest.mark.parametrize("scan_k", [1, 2])
def test_the_engine_opens_its_spans_and_times_the_unpacking(scan_k):
    cfg, px = _config("fast", "float32")
    state = _state(cfg, None)
    eng = TileInferenceEngine(state, cfg, batch_size=2, device="cpu",
                              mask_format="bits", scan_k=scan_k)
    tiles = _tiles(7, px)
    feed = [tiles[i:i + 2] for i in range(0, 7, 2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(eng.run(iter(feed)))
    assert [len(d["scores"]) for d in got] == [2, 2, 2, 1]
    names = {e.name for e in prof.events()}
    for name in ("engine.stage", "engine.dispatch", "engine.drain",
                 "engine.unpack") + STAGES:
        assert name in names, name
    assert eng.stats["unpack_s"] > 0 and set(eng.stats) == {
        "h2d_s", "d2h_s", "unpack_s"}
    assert not hasattr(eng, "elapsed")


def test_no_profiler_no_range(monkeypatch):
    """With no profiler on, neither the forward nor the engine enters a
    ``record_function`` range: a span is one check and nothing else."""
    cfg, px = _config("parity", "float32")
    state = _state(cfg, None)
    want = TileInferenceEngine(state, cfg, batch_size=2, device="cpu",
                               mask_format="bits")
    want = list(want.run(iter([_tiles(2, px)])))

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    for k in (1, 2):
        eng = TileInferenceEngine(state, cfg, batch_size=2, device="cpu",
                                  mask_format="bits", scan_k=k)
        got = list(eng.run(iter([_tiles(2, px)])))
        for key in want[0]:
            np.testing.assert_array_equal(got[0][key], want[0][key])


# -- portbench/stages.py on synthetic kineto events ------------------------

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """The few methods of ``torch._C._autograd._KinetoEvent`` that
    ``trace.summarize`` and ``stages.by_stage`` call."""

    def __init__(self, name, start, end, dev=CPU, corr=0, linked=0,
                 annotation=False, tid=1):
        self._n, self._s, self._e = name, start, end
        self._dev, self._corr, self._linked = dev, corr, linked
        self._ann, self._tid = annotation, tid

    def name(self):
        return self._n

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def is_user_annotation(self):
        return self._ann

    def start_thread_id(self):
        return self._tid


def _span(name, s, e, corr, tid=1):
    return Ev(name, s, e, corr=corr, annotation=True, tid=tid)


def _events():
    """A window [100, 1000] ns over two forwards' stages and a replay:
    every device op's launching host op and its stage."""
    return [
        Ev(ptrace.WINDOW, 100, 1000, corr=1, annotation=True),
        _span("engine.dispatch", 50, 700, 2),
        _span("forward.backbone", 60, 200, 3),
        Ev("aten::conv", 70, 80, corr=4),            # -> backbone
        _span("forward.fpn", 200, 300, 5),
        _span("forward.mask_head", 300, 400, 6),
        Ev("aten::add", 310, 320, corr=7),
        _span("portbench.inner", 330, 340, 8),       # innermost: not a stage
        Ev("aten::mul", 332, 335, corr=9),           # -> mask_head still
        Ev("aten::copy_", 450, 460, corr=10),        # in no stage: dispatch
        _span("graph.replay", 500, 520, 11),         # one launch, no stage
        Ev("cudaLaunchKernel", 72, 75, corr=12, linked=4),  # runtime: skip
        # device ops, each linked to its launching host op
        Ev("conv_kernel", 90, 150, CUDA, linked=4),      # clipped to 100
        Ev("fpn_kernel", 210, 260, CUDA, linked=5),      # the span itself
        Ev("add_kernel", 320, 380, CUDA, linked=7),
        Ev("mul_kernel", 380, 400, CUDA, linked=9),
        Ev("forward.mask_head", 320, 400, CUDA, annotation=True, linked=6),
        Ev("Memcpy HtoD", 460, 470, CUDA, linked=10),
        Ev("replayed_kernel", 520, 900, CUDA, linked=11),
        Ev("late_kernel", 980, 1100, CUDA, linked=7),    # clipped to 1000
        Ev("other_thread", 300, 310, CUDA, linked=13),
        Ev("aten::add", 350, 360, corr=13, tid=2),       # no stage on tid 2
    ]


def test_by_stage_puts_each_device_op_down_to_its_launching_stage():
    got = stages.by_stage(_events())
    assert got == pytest.approx({"forward.backbone": 50e-9,
                                 "forward.fpn": 50e-9,
                                 "forward.mask_head": (60 + 20 + 20) * 1e-9})
    assert stages.by_stage(_events()[1:]) is None


def test_by_stage_leaves_summarize_as_it_was():
    """``summarize`` reads the same events as before, and its keys are
    unchanged; the stage split is one key beside them."""
    want = ptrace.summarize(_events())
    assert set(want) == {"window_s", "busy_s", "by_category", "launches",
                         "device_ops", "idle_gaps"}
    assert want["busy_s"] == pytest.approx(
        (50 + 50 + 10 + 80 + 10 + 380 + 20) * 1e-9)
    tracer = stages.StageTracer(cuda=False)
    tracer.start()
    tracer.begin()
    with profiling.span("forward.backbone"):
        torch.ones(8).sum()
    tracer.end()
    prof = tracer.prof
    tracer.stop()
    got = dict(tracer.summary)
    assert got.pop("by_stage") == {}           # no device op on the CPU
    assert got == ptrace.summarize(prof.profiler.kineto_results.events())


def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("stage", STAGES)
def test_stage_us_reads_device_us_a_tile(stage):
    summary = {"launches": {"roi_align": 8}, "by_stage": {
        "forward.backbone": 0.002, "forward.mask_head": 0.001}}
    ctx = SimpleNamespace(trace=summary, batch=16)     # 64 tiles
    want = {"forward.backbone": 31.25, "forward.mask_head": 15.625}
    got = stages.stage_us(ctx, stage)
    assert got == pytest.approx(want[stage]) if stage in want else got is None
    assert stages.stage_us(SimpleNamespace(trace=None, batch=16),
                           stage) is None
    no_split = SimpleNamespace(trace={"launches": {"roi_align": 8}},
                               batch=16)
    assert stages.stage_us(no_split, stage) is None


def test_unpack_ms_reads_the_engine_counter():
    read = _reader("engine.unpack_ms")
    assert read(SimpleNamespace(stats={"unpack_s": 0.5}, dispatches=250)) \
        == pytest.approx(2.0)
    assert read(SimpleNamespace(stats={"h2d_s": 1.0}, dispatches=250)) \
        is None                         # an engine without the counter
    assert read(SimpleNamespace(stats={"unpack_s": 0.5}, dispatches=0)) \
        is None
