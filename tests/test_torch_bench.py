"""``tools/bench.py`` against the reference's benchmark ``bench.py``, on
the CPU.

1. The knobs: for each setting of ``BENCH_PROFILE``, ``BENCH_BATCH``,
   ``BENCH_STEPS``, ``BENCH_TOPK``, ``BENCH_INT8``, ``BENCH_INT8_SCOPE``,
   ``BENCH_INT8_PYR`` and ``BENCH_SCANK``, the script's ``main`` runs with
   ``init_params``, ``prepare_quantized``, the forward's makers and
   ``jax.jit`` replaced by recorders, and with a recorder in place of the
   ``default_rng(0)`` generator's draws, which returns one byte a draw (at
   the defaults a draw is 1.61 GB). The tool's config equals the script's
   field for field, and so do the batch, the steps (the timed draws are
   the steps, and the warm-up's draw comes after them), k, the input
   shape, the calibration tiles (shape, dtype, sum) and the choice of the
   scan call or the single one. The script stops at its warm-up call.
2. The JSON line: the script's ``main`` with its clock replaced prints
   the tool's ``result_line`` for the same tiles/s: the keys, the metric
   names, the unit and the rounding of ``value`` and ``vs_baseline``.
3. A one-step run of the tool on ``device="cpu"`` at a narrow width in
   float32 on 64 px tiles, on the JAX package's weights bridged by
   ``from_jax_params``: at k=2 (the scan call) and at k=1 (the single
   forward), each step's scalar equals the reference's ``scores.sum()``
   (its jitted ``make_inference_scan_fn`` or ``make_inference_fn``) on the
   same draws, within the forward's score tolerance of 1e-6 a score plus
   the float32 rounding of the sum. On the int8 pyramid at k=2 the quant
   tree is the reference's, made by its ``prepare_quantized`` on the
   tool's own calibration tiles (``tests/test_torch_port_quant_forward.py``
   holds the port's calibration to it), and the reference is compiled as
   that test compiles it; the tolerance is its, 1e-6 a score.
4. Without a card the tool raises before it stages or times anything.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import roadsurf_tpu.models as j_models
import roadsurf_tpu.models.mask_rcnn as jm
import roadsurf_tpu.models.quant as j_quant
from roadsurf_tpu_torch.tools import bench, profile_stages
from roadsurf_tpu_torch.utils.weights import from_jax_params, from_jax_quant
from test_torch_ablations import _narrow_port_cfg
from test_torch_measure_stages import fakes, same_cfg, \
    set_env  # noqa: F401
from test_torch_port_model import narrow_cfg as j_narrow_cfg, narrow_tree
from test_torch_port_quant_forward import f32_pooling  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIDE = 64
NO_FUSION = {"xla_disable_hlo_passes": "fusion",
             "xla_allow_excess_precision": False}


class Stop(Exception):
    """Raised by a recorder to end the script's ``main`` early."""


def reference_bench():
    spec = importlib.util.spec_from_file_location("reference_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(monkeypatch, fakes, env: dict, call=None) -> dict:
    """The recorders in place (see the module's docstring, 1); ``call``
    stands in for the jitted forward (default: raise ``Stop``)."""
    seen = {"draws": []}
    real_rng = np.random.default_rng

    def init_params(key, cfg):
        seen["cfg"] = cfg
        return {}

    def prepare(params, cal, cfg, *a, **kw):
        seen["cal"] = (cal.shape, cal.dtype, int(cal.sum()))
        return {}

    def maker(kind):
        def make(cfg, with_masks=True, mask_format="logits"):
            seen["made"] = (kind, cfg, with_masks, mask_format)
            return kind
        return make

    class Jit:
        def __init__(self, fn, **kw):
            seen["jitted"] = fn

        def __call__(self, params, x):
            if call is None:
                raise Stop
            return call(params, x)

    class Rng:
        """``default_rng``: the seed-0 generator's draws are recorded and
        one byte each; any other seed draws as numpy does."""

        def __init__(self, seed):
            self.seed, self.rng = seed, real_rng(seed)

        def integers(self, low, high, size, dtype):
            if self.seed != 0:
                return self.rng.integers(low, high, size, dtype=dtype)
            seen["draws"].append((low, high, tuple(size), np.dtype(dtype)))
            return np.zeros(1, dtype)

    monkeypatch.delenv("BENCH_SCANK", raising=False)
    set_env(monkeypatch, env)
    fakes.set(j_models, "init_params", init_params)
    fakes.set(j_models, "make_inference_fn", maker("single"))
    fakes.set(jm, "make_inference_scan_fn", maker("scan"))
    fakes.set(j_quant, "prepare_quantized", prepare)
    fakes.set(jax, "jit", Jit)
    fakes.set(np.random, "default_rng", Rng)
    return seen


# ---------------------------------------------------------------------------
# 1. the knobs

KNOB_SETTINGS = [
    {}, {"BENCH_PROFILE": "parity"}, {"BENCH_INT8": "0"},
    {"BENCH_PROFILE": "parity", "BENCH_INT8": "0"}, {"BENCH_TOPK": "64"},
    {"BENCH_INT8_SCOPE": "backbone", "BENCH_INT8_PYR": "0"},
    {"BENCH_INT8_SCOPE": "backbone"}, {"BENCH_INT8_SCOPE": "convnet"},
    {"BENCH_SCANK": "1"},
    {"BENCH_PROFILE": "parity", "BENCH_SCANK": "1", "BENCH_BATCH": "4",
     "BENCH_STEPS": "2"},
    {"BENCH_PROFILE": "other", "BENCH_BATCH": "64", "BENCH_SCANK": "8",
     "BENCH_STEPS": "5"},
]


@pytest.mark.parametrize("env", KNOB_SETTINGS)
def test_the_knobs_give_the_scripts_settings(monkeypatch, fakes, env):
    seen = _record(monkeypatch, fakes, env)
    with pytest.raises(Stop):
        reference_bench().main()
    got = bench.settings(env)
    cfg = got["cfg"]
    kind, made_cfg, with_masks, mask_format = seen["made"]
    assert seen["jitted"] == kind
    assert kind == ("scan" if got["scan_k"] > 1 else "single")
    same_cfg(cfg, made_cfg)
    # the weights' config is the forward's before the int8 settings
    same_cfg(replace(cfg, int8_scope="", int8_pyramid=False), seen["cfg"])
    assert (with_masks, mask_format) == (True, "logits")
    shape = bench.input_shape(got["batch"], got["scan_k"])
    # the steps' draws, then the warm-up's
    assert seen["draws"] == [(0, 255, shape, np.dtype(np.uint8))] \
        * (got["steps"] + 1)
    assert shape[-4] == got["batch"]
    if cfg.int8_scope:
        cal = np.random.default_rng(1).integers(
            0, 255, (profile_stages.CAL_TILES, bench.TILE, bench.TILE, 3),
            dtype=np.uint8)
        assert seen["cal"] == (cal.shape, cal.dtype, int(cal.sum()))
    else:
        assert "cal" not in seen


# ---------------------------------------------------------------------------
# 2. the JSON line

@pytest.mark.parametrize("profile,dt", [("fast", 0.0123), ("fast", 3.0),
                                        ("parity", 7.77), ("other", 0.5)])
def test_the_json_line_is_the_scripts(monkeypatch, fakes, capsys, profile,
                                      dt):
    batch, k, steps = 3, 2, 2
    _record(monkeypatch, fakes, {"BENCH_PROFILE": profile,
                                 "BENCH_INT8": "0", "BENCH_BATCH": str(batch),
                                 "BENCH_SCANK": str(k),
                                 "BENCH_STEPS": str(steps)},
            call=lambda p, x: {"scores": np.ones(4, np.float32)})
    mod = reference_bench()
    clock = iter([100.0, 100.0 + dt])
    mod.time = types.SimpleNamespace(perf_counter=lambda: next(clock))
    mod.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench.result_line(profile, batch * k * steps / dt)
    assert list(got) == list(want)
    assert got == want


# ---------------------------------------------------------------------------
# 3. the tool's run against the reference's calls

def _tool_run(capsys, cfg, tree, scan_k: int) -> tuple:
    """The tool's one-step run at a narrow width on the CPU; (its readings,
    the step's input as numpy, its printed last line)."""
    env = {"BENCH_BATCH": "2", "BENCH_STEPS": "1",
           "BENCH_SCANK": str(scan_k)}
    res = bench.run(env=env, device="cpu", cfg=cfg, tile=SIDE,
                    state=from_jax_params(tree))
    shape = bench.input_shape(2, scan_k, SIDE)
    assert res["input_shape"] == list(shape)
    x = np.random.default_rng(0).integers(0, 255, shape, dtype=np.uint8)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return res, x, last


def _close_sum(got: float, scores) -> None:
    """1e-6 a score, plus the float32 rounding of a sum of n scores."""
    scores = np.asarray(scores)
    n = scores.size
    want = float(scores.sum())
    tol = 1e-6 * n + n * 2.0 ** -24 * float(np.abs(scores).sum())
    assert abs(got - want) <= tol, (got, want, tol)


@pytest.mark.parametrize("scan_k", [2, 1])
def test_each_steps_scalar_is_the_references_score_sum(capsys, scan_k):
    jcfg = j_narrow_cfg(SIDE)
    tree = narrow_tree(jcfg)
    res, x, last = _tool_run(capsys, _narrow_port_cfg(), tree, scan_k)
    make = jm.make_inference_scan_fn if scan_k > 1 else jm.make_inference_fn
    ref = jax.jit(make(jcfg, with_masks=True))(tree, jnp.asarray(x))
    assert np.asarray(ref["valid"]).any()
    assert len(res["scalars"]) == 1
    _close_sum(res["scalars"][0], ref["scores"])
    assert last == bench.result_line("fast", res["tiles_per_s"])
    assert res["card"] == "cpu" and res["capture_s"] is None


def test_each_steps_scalar_is_the_references_on_the_int8_pyramid(
        monkeypatch, capsys, f32_pooling):  # noqa: F811
    jcfg = replace(j_narrow_cfg(SIDE), int8_scope="full", int8_pyramid=True)
    tcfg = replace(_narrow_port_cfg(), int8_scope="full", int8_pyramid=True)
    tree = narrow_tree(jcfg)
    quant = {}

    def prepare(state, cal, cfg, device=None):
        want = np.random.default_rng(1).integers(
            0, 255, (profile_stages.CAL_TILES, SIDE, SIDE, 3), np.uint8)
        np.testing.assert_array_equal(cal, want)
        quant["tree"] = jax.device_get(j_quant.prepare_quantized(tree, cal,
                                                                 jcfg))
        return from_jax_quant(quant["tree"])

    monkeypatch.setattr(profile_stages, "prepare_quantized", prepare)
    res, x, _ = _tool_run(capsys, tcfg, tree, 2)
    params = dict(tree, quant=quant["tree"])
    scan = jax.jit(jm.make_inference_scan_fn(jcfg, with_masks=True))
    ref = scan.lower(params, jnp.asarray(x)).compile(
        compiler_options=NO_FUSION)(params, jnp.asarray(x))
    assert np.asarray(ref["valid"]).any()
    _close_sum(res["scalars"][0], ref["scores"])
    assert (res["int8_scope"], res["int8_pyramid"]) == ("full", True)


# ---------------------------------------------------------------------------
# 4. no card

def test_the_tool_raises_without_a_card_before_it_times_anything(
        monkeypatch):
    def unreachable(*a, **kw):
        raise AssertionError("reached without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("model_state", "staged", "time_lag1"):
        monkeypatch.setattr(bench, name, unreachable)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(env={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.Bench({"BENCH_PROFILE": "parity"})


def test_the_fields_of_a_setting_are_the_configs():
    """The settings hold a port ``ModelConfig``, not a copy of its
    fields, and the tool's defaults are the script's documented ones."""
    s = bench.settings({})
    assert dataclasses.is_dataclass(s["cfg"])
    assert (s["batch"], s["steps"], s["scan_k"]) == (512, 3, 16)
    assert bench.input_shape(512, 16) == (16, 512, 256, 256, 3)
    p = bench.settings({"BENCH_PROFILE": "parity"})
    assert (p["batch"], p["steps"], p["scan_k"]) == (16, 3, 4)
    assert p["cfg"].min_size_test == 800
