"""The ported microbenchmarks (``tools/bench_pooler.py``,
``tools/bench_int8_gemm.py``, ``tools/bench_conv_dtypes.py``,
``tools/bench_pooler_variants.py``) against the reference's scripts of the
same names, on the CPU.

1. The rows: each script's ``main`` runs with ``jax.jit`` replaced by a
   recorder; the cases, shapes and variants it prints are the tool's (the
   pooler's also under ``BENCH_CASES`` and ``BENCH_PALLAS=0``; the conv
   tool adds ``i8/K4`` on the 1x1 shapes, K4's product, which the script
   has no row for).
2. The variants compute one function: on cut shapes, K4 (``pl-i8``) equals
   ``torch._int_mm`` (``xla-i8``) and the int8 values' bf16 product
   within its rounding; the int8 conv (``i8/i32``) equals K4's product
   (``i8/K4``) exactly and the bf16 convs within one bf16 rounding; the
   pooler's K1 row equals its separable rows within K1's tolerance.
   ``bench_pooler_variants``: every row the script prints is a row of
   the tool, run or named as having no CUDA counterpart (its TPU layout
   devices), under ``BENCH_CASES`` too; the tool's knobs (pooler, int8)
   give the script's shapes and scales.
3. Without a card each tool raises before it times anything.
4. Faking ``jax.jit`` for a script leaves the reference's Pallas poolers
   real: in a fresh process, ``bench_pooler``'s ``main`` under
   ``FakeJit`` (which imports ``roadsurf_tpu.ops.roi_align_pallas``), then
   K1's interpreted TPU kernel against its plain version.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax

from roadsurf_tpu_torch.tools import bench_conv_dtypes, bench_int8_gemm, \
    bench_pooler, bench_pooler_variants
from test_torch_measure_stages import FakeJit, fakes, script, \
    set_env  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("env", [{}, {"BENCH_CASES": "R=8"},
                                 {"BENCH_PALLAS": "0", "BENCH_CASES": "ic=16"}])
def test_bench_pooler_cases_are_the_scripts(monkeypatch, fakes, capsys,
                                           env):
    set_env(monkeypatch, dict(env, BENCH_BATCH="1", BENCH_STEPS="1"))
    fakes.set(jax, "jit", FakeJit)
    script("bench_pooler").main()
    want = [ln[:28].strip() for ln in capsys.readouterr().out.splitlines()
            if ln.strip()]
    s = bench_pooler.settings(env)
    got = [name for name, _, _ in bench_pooler.cases(s["pallas"],
                                                     s["cases"])]
    assert got == want and want


def test_bench_int8_gemm_shapes_are_the_scripts(monkeypatch, fakes, capsys):
    set_env(monkeypatch, {"BENCH_KREP": "1", "BENCH_STEPS": "1"})
    fakes.set(jax, "jit", FakeJit)
    script("bench_int8_gemm").main()
    out = capsys.readouterr().out
    shapes = re.findall(r"^(.+?)  M=(\d+) K=(\d+) N=(\d+)", out, re.M)
    assert [(t, int(m), int(k), int(n)) for t, m, k, n in shapes] \
        == bench_int8_gemm.shapes()
    names = re.findall(r"^  (\S+) ", out, re.M)
    assert names == [v for v, _, _ in bench_int8_gemm.variants()] \
        * len(shapes)


def test_bench_conv_dtypes_shapes_are_the_scripts(monkeypatch, fakes,
                                                  capsys):
    set_env(monkeypatch, {"BENCH_KREP": "1", "BENCH_STEPS": "1"})
    fakes.set(jax, "jit", FakeJit)
    script("bench_conv_dtypes").main()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    shapes = bench_conv_dtypes.shapes()
    assert [ln[:16].strip() for ln in lines] == [s[0] for s in shapes]
    src = open(script("bench_conv_dtypes").__file__).read()
    for s in shapes:
        tag, B, H, W, Ci, Co, k, st = s
        assert f'("{tag}",' in src and re.search(
            rf'\("{re.escape(tag)}",\s*{B}, {H}, {W}, {Ci}, {Co}, {k}, '
            rf'{st}\)', src), s
    for ln, s in zip(lines, shapes):
        want = re.findall(r"(\S+)\s+[\d.]+ms=", ln)
        got = [v for v, _, _ in bench_conv_dtypes.variants(s[6], s[7])
               if v != "i8/K4"]
        assert got == want


def test_the_gemm_variants_agree():
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 127, (96, 72), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 127, (72, 40), generator=g, dtype=torch.int8)
    out = {n: fn(a, w) for n, fn, _ in bench_int8_gemm.variants()}
    assert out["pl-i8"].dtype == out["xla-i8"].dtype == torch.int32
    assert torch.equal(out["pl-i8"], out["xla-i8"])
    ref = out["xla-i8"].float()
    err = (out["xla-bf16"].float() - ref).abs()
    assert (err <= 2.0 ** -8 * ref.abs() + 1e-3).all()


@pytest.mark.parametrize("shape", [("1x1", 2, 8, 8, 64, 32, 1, 1),
                                   ("3x3", 2, 8, 8, 32, 16, 3, 1)])
def test_the_conv_variants_agree(shape):
    k, st = shape[6], shape[7]
    xi, wi = bench_conv_dtypes.inputs(1, 1, shape, torch.int8,
                                      torch.device("cpu"))[0]
    xb, wb = bench_conv_dtypes.inputs(1, 1, shape, torch.bfloat16,
                                      torch.device("cpu"))[0]
    assert torch.equal(xi.float(), xb.float())
    out = {}
    for name, fn, dtype in bench_conv_dtypes.variants(k, st):
        x, w = (xi, wi) if dtype == torch.int8 else (xb, wb)
        y = fn(x, w)
        out[name] = y.permute(0, 2, 3, 1).reshape(-1, y.shape[1]) \
            if y.dim() == 4 else y
    ref = out["i8/i32"].float()
    assert torch.equal(ref, ref.round())
    if k == 1:
        assert torch.equal(out["i8/K4"].float(), ref)
    for name in ("i8>bf16", "bf16"):
        err = (out[name].float() - ref).abs()
        assert (err <= 2.0 ** -8 * ref.abs() + 1e-3).all(), name


def test_the_pooler_rows_agree():
    feats, boxes, lvl = bench_pooler.inputs(1, 2, 8, torch.device("cpu"))
    rows = {n: fn(feats, boxes, lvl) for n, fn, _ in
            bench_pooler.cases(True, "R=8")}
    ref = rows["separable ic=4 R=8 P=14"]
    for name, got in rows.items():
        err = (got.float() - ref).abs()
        assert (err <= 2.0 ** -8 * ref.abs() + 1e-4).all(), name


@pytest.mark.parametrize("env", [{}, {"BENCH_POOLER": "mask",
                                      "BENCH_INT8": "1"},
                                 {"BENCH_CASES": "full"}])
def test_bench_pooler_variants_rows_are_the_scripts(monkeypatch, fakes,
                                                    capsys, env):
    # a batch every image grouping of the script divides
    set_env(monkeypatch, dict(env, BENCH_BATCH="32", BENCH_STEPS="1"))
    fakes.set(jax, "jit", FakeJit)
    script("bench_pooler_variants").main()
    want = [re.split(r"\s+(?:FAILED|[\d.]+ ms/batch)", ln)[0].strip()
            for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    got = [name for name, _ in bench_pooler_variants.rows(env)]
    assert want and set(want) <= set(got)
    missing = set(got) - set(want)
    assert missing <= {"stage=weights", "stage=copy", "stage=xpass",
                       "blocked"}
    assert set(bench_pooler_variants.NO_COUNTERPART) & set(got) \
        <= set(want)
    s = bench_pooler_variants.settings(env)
    assert (s["R"], s["P"]) == ((8, 14) if env.get("BENCH_POOLER")
                                else (32, 7))
    feats, boxes, lvl, sc = bench_pooler_variants.inputs(
        1, 2, s["R"], s["int8"], torch.device("cpu"))
    assert [f.shape[1] for f in feats] == [64, 32, 16]
    assert boxes.shape == (2, s["R"], 4)
    assert (sc is None) != s["int8"]
    if s["int8"]:
        assert sc.tolist() == pytest.approx([0.11, 0.23, 0.47])


def test_the_microbenchmarks_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for mod in (bench_pooler, bench_int8_gemm, bench_conv_dtypes,
                bench_pooler_variants):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run(env={})


GUARD = """
import sys
import jax
import numpy as np
import pytest
from test_torch_measure_stages import FakeJit, Fakes, script, set_env
from test_torch_port_int8_poolers import k1_int8_case, \\
    k1_int8_plain_and_interpreted

POOLERS = "roadsurf_tpu.ops.roi_align_pallas"
assert POOLERS not in sys.modules, "the poolers are imported already"
monkeypatch = pytest.MonkeyPatch()
fakes = Fakes(monkeypatch)
set_env(monkeypatch, {"BENCH_BATCH": "1", "BENCH_STEPS": "1",
                      "BENCH_CASES": "R=8"})
fakes.set(jax, "jit", FakeJit)
script("bench_pooler").main()
fakes.undo()
from roadsurf_tpu.ops.roi_align_pallas import roi_align_fused
assert not isinstance(roi_align_fused, FakeJit), roi_align_fused
got, ref = k1_int8_plain_and_interpreted(*k1_int8_case())
assert ref.shape == (2, 8, 7, 7, 8), ref.shape
np.testing.assert_allclose(got.numpy(), ref, atol=2e-2)
"""


def test_a_faked_jit_leaves_the_pallas_poolers_real():
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(tests), str(tests.parent),
                                           os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", GUARD], cwd=tests.parent,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
