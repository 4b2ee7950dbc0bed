"""``tools/bench_training.py`` and ``tools/profile_training.py`` against
the reference's scripts of the same names, and every ported tool's knobs
against its script's, on the CPU.

1. Knobs: the ``BENCH_*`` environment variables each script reads, with
   their defaults, are the ones its tool reads (read from the sources).
2. ``bench_training``: for each setting of ``BENCH_TRAIN_BATCHES``,
   ``BENCH_TRAIN_SIZE``, ``BENCH_STEPS`` and ``BENCH_TRAIN_SCANK``, the
   script's ``main`` with ``bench_one`` recorded makes the same calls (the
   model config field for field, size, batch, steps, label, scan_k) as
   the tool's ``settings``; ``synth_batch`` draws the script's arrays; the
   script's JSON keys (its ``bench_one`` run on recorders) are in the
   tool's line; one tool step on the CPU (narrow width, 64 px, scan_k 1
   and 2) has a finite loss and its MFU is its count against 989e12.
3. ``profile_training``: its config and rows are the script's (``main``
   on recorders); each row's loss subset equals the sum of the
   reference's ``compute_losses`` on the same parameters, batch and
   sampling uniforms within ``test_torch_train_step.py``'s rtol 1e-5
   (atol 1e-6).
"""

from __future__ import annotations

import math
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import roadsurf_tpu.engine.train as j_train
from roadsurf_tpu_torch.tools import bench_training, profile_training
from roadsurf_tpu_torch.utils.weights import from_jax_train_params
from test_torch_measure_stages import FakeJit, fakes, same_cfg, script, \
    set_env, table_rows  # noqa: F401
from test_torch_port_model import narrow_tree
from test_torch_train_step import jax_draws

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NARROW = {"fpn_channels": 32, "box_fc_dim": 64, "mask_conv_dim": 32,
          "compute_dtype": "float32"}
# each reference script and the tool that ports it
TOOLS = {"profile_stages": "profile_stages", "profile_heads":
         "profile_heads", "profile_proposals": "profile_proposals",
         "bench_proposals": "bench_proposals", "bench_training":
         "bench_training", "profile_training": "profile_training",
         "bench_pooler": "bench_pooler", "bench_int8_gemm":
         "bench_int8_gemm", "bench_conv_dtypes": "bench_conv_dtypes",
         "bench_pooler_variants": "bench_pooler_variants"}
KNOB = re.compile(r"""(?:os\.environ|env)\.get\(\s*"(BENCH_\w+)",\s*"([^"]*)\"""")


def _knobs(path: Path) -> set:
    return set(KNOB.findall(path.read_text()))


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_the_tools_read_the_scripts_knobs(name):
    want = _knobs(ROOT / "scripts" / f"{name}.py")
    got = _knobs(ROOT / "roadsurf_tpu_torch" / "tools" / f"{TOOLS[name]}.py")
    assert want and got == want


# ---------------------------------------------------------------------------
# 2. bench_training

TRAIN_SETTINGS = [{}, {"BENCH_TRAIN_BATCHES": "4,16,32",
                       "BENCH_TRAIN_SIZE": "128", "BENCH_STEPS": "2"},
                  {"BENCH_TRAIN_BATCHES": "8,64", "BENCH_TRAIN_SCANK": "2"}]


@pytest.mark.parametrize("env", TRAIN_SETTINGS)
def test_bench_training_calls_are_the_scripts(monkeypatch, env):
    mod = script("bench_training")
    calls = []
    monkeypatch.setattr(mod, "bench_one", lambda cfg, size, batch, steps,
                        label, scan_k=1: calls.append(
                            (cfg, size, batch, steps, label, scan_k)))
    set_env(monkeypatch, env)
    mod.main()
    s = bench_training.settings(env)
    assert len(calls) == len(s["runs"]) == len(s["batches"])
    for (cfg, size, batch, steps, label, k), (tc, tb, tl, tk) in zip(
            calls, s["runs"]):
        same_cfg(tc, cfg)
        assert (size, batch, steps, label, k) \
            == (s["size"], tb, s["steps"], tl, tk)


def test_synth_batch_draws_the_scripts_arrays():
    mod = script("bench_training")
    want = mod.synth_batch(np.random.default_rng(5), 3, 64)
    got = bench_training.synth_batch(np.random.default_rng(5), 3, 64)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


class _Compiled:
    def cost_analysis(self):
        return {"flops": 2.0e12}


class _CostJit(FakeJit):
    """A jit whose ``lower().compile().cost_analysis()`` counts 2 TFLOP
    and whose call returns (state, {"total": 0.5})."""

    def lower(self, *a):
        return type("L", (), {"compile": lambda s: _Compiled()})()

    def __call__(self, state, batch):
        return state, {"total": 0.5}


def _script_keys(fakes, capsys, scan_k: int) -> list:
    import json

    mod = script("bench_training")
    fakes.set(j_train, "init_train_state", lambda key, cfg: {})
    fakes.set(j_train, "make_train_step", lambda cfg, s: None)
    fakes.set(j_train, "make_train_scan_step", lambda cfg, s, k: None)
    fakes.set(jax, "jit", _CostJit)
    mod.bench_one(None, 32, 1, 1, "32px", scan_k=scan_k)
    return list(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))


@pytest.mark.parametrize("scan_k", [1, 2])
def test_one_bench_training_step_on_the_cpu(fakes, capsys, scan_k):
    want = _script_keys(fakes, capsys, scan_k)
    assert want == list(bench_training.KEYS)
    cfg = replace(bench_training.settings({})["runs"][0][0], **NARROW)
    line = bench_training.bench_one(cfg, 64, 2, 1, "64px", scan_k=scan_k,
                                    device="cpu")
    assert list(line)[:len(want)] == want
    assert math.isfinite(line["loss"])
    assert line["gflop_per_step"] > 0
    assert line["mfu"] == pytest.approx(
        line["gflop_per_step"] * 1e9 * line["steps_per_sec"] / 989e12,
        rel=1e-12)
    assert line["peak"] == 989e12


# ---------------------------------------------------------------------------
# 3. profile_training

@pytest.mark.parametrize("env", [{}, {"BENCH_CHUNKS": "2",
                                      "BENCH_REMAT": "1"}])
def test_profile_training_config_and_rows_are_the_scripts(
        monkeypatch, fakes, capsys, env):
    seen = {}

    def init(key, cfg):
        seen["cfg"] = cfg
        return {"params": {}}

    set_env(monkeypatch, dict(env, BENCH_BATCH="1", BENCH_STEPS="1"))
    fakes.set(j_train, "init_train_state", init)
    fakes.set(jax, "jit", FakeJit)
    fakes.set(jax, "block_until_ready", lambda x: x)
    script("profile_training").main()
    same_cfg(profile_training.settings(env)["cfg"], seen["cfg"])
    rows = table_rows(capsys.readouterr().out, "branch")
    assert rows == [name for name, _ in profile_training.SUBSETS]


def test_profile_training_subsets_are_the_references_losses():
    """Narrow width at 64 px, B=2, the script's budgets: each subset's
    loss against the reference's compute_losses summed over its keys."""
    from roadsurf_tpu.models import fast_profile as j_fast

    S, B = 64, 2
    knobs = dict(NARROW, min_size_test=S, max_size_test=S,
                 rpn_pre_nms_topk_train=2000, rpn_post_nms_topk_train=1000,
                 roi_batch_per_image=1024, rpn_batch_per_image=256)
    jcfg = replace(j_fast(), **knobs)
    tcfg = replace(profile_training.settings({})["cfg"], **NARROW,
                   min_size_test=S, max_size_test=S)
    tree = narrow_tree(jcfg)
    batch = profile_training.make_batch(np.random.default_rng(0), B, S)
    key = jax.random.PRNGKey(3)
    ref = j_train.compute_losses(tree, batch, key, jcfg, S)
    state = {"params": from_jax_train_params(tree)}
    draws = jax_draws(key, tcfg, S, B, profile_training.GT)
    tb = profile_training.to_device(batch, torch.device("cpu"))
    for name, keys in profile_training.SUBSETS:
        got = profile_training.subset_loss(state["params"], tb, draws, tcfg,
                                           keys, S)
        want = sum(float(ref[k]) for k in keys)
        np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_profile_training_runs_on_the_cpu(capsys):
    cfg = replace(profile_training.settings({})["cfg"], **NARROW,
                  roi_batch_per_image=64, rpn_batch_per_image=32)
    rows = profile_training.run(env={}, device="cpu", cfg=cfg, batch=2,
                                steps=1, size=64)
    assert [r["branch"] for r in rows] == [n for n, _ in
                                           profile_training.SUBSETS]
    assert rows[0]["tflop"] < rows[1]["tflop"] < rows[2]["tflop"]
    assert all(math.isfinite(r["scalar"]) and r["scalar"] > 0 for r in rows)
