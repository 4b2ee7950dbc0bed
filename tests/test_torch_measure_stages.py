"""``tools/profile_stages.py`` against the reference's
``scripts/profile_stages.py``, on the CPU.

1. The knobs: for each setting of ``BENCH_PROFILE``, ``BENCH_BATCH``,
   ``BENCH_STEPS``, ``BENCH_TOPK``, ``BENCH_INT8``, ``BENCH_INT8_SCOPE``
   and ``BENCH_INT8_PYR``, the script's ``main`` runs with ``init_params``,
   ``prepare_quantized`` and ``jax.jit`` replaced by recorders: its model
   config equals the tool's field for field, and so do the batch, the
   steps, the calibration tiles' shape and, with ``BENCH_STAGES``, the
   rows (the names of its printed table).
2. The stages: at a narrow width in float32 on 64 px tiles, each stage of
   the tool, on the JAX package's weights bridged by ``from_jax_params``,
   equals the JAX functions it composes (the script's stage bodies):
   feature maps, the RPN's outputs and the proposals' scores (the RPN's
   logits they kept) within 1e-5·max|ref| (conv summation order), the
   proposals' and detections' boxes within 1e-4 px, the detections'
   scores within 1e-6, ``valid`` and ``classes`` exact, the mask logits
   within 1e-4 (``test_torch_port_model.py``'s forward tolerances).
3. The FULL row is ``forward_prepared(..., "logits")``, bit for bit, on
   the fast profile in float32 and on its int8 pyramid, and on the
   parity profile (64 px tiles resized to 96, whose boxes the forward,
   not the script's row, scales back to the tile): the stages are built
   from the functions the forward runs, in its order.
4. Without a card the tool raises before it times anything.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import importlib.util
import pkgutil
import re
import sys
import weakref
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import roadsurf_tpu.models as j_models
import roadsurf_tpu.models.quant as j_quant
from roadsurf_tpu.models.anchors import all_level_anchors
from roadsurf_tpu.models.mask_rcnn import forward_features as j_ff, \
    preprocess as j_pre
from roadsurf_tpu.models.resnet import conv_bn as j_conv_bn, \
    max_pool as j_max_pool, resnet_forward as j_resnet
from roadsurf_tpu.models.roi_heads import box_head_forward as j_box, \
    inference_detections as j_dets, mask_head_forward as j_mask
from roadsurf_tpu.models.rpn import rpn_head_forward as j_rpn, \
    select_proposals as j_select
from roadsurf_tpu_torch.models.mask_rcnn import forward_prepared
from roadsurf_tpu_torch.tools import profile_stages
from roadsurf_tpu_torch.utils.weights import from_jax_params
from test_torch_port_model import narrow_cfg as j_narrow_cfg, narrow_tree
from test_torch_ablations import _narrow_port_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIDE = 64
BENCH_KNOBS = ("BENCH_PROFILE", "BENCH_BATCH", "BENCH_STEPS", "BENCH_TOPK",
               "BENCH_INT8", "BENCH_INT8_SCOPE", "BENCH_INT8_PYR",
               "BENCH_STAGES", "BENCH_CHUNKS", "BENCH_REMAT",
               "BENCH_TRAIN_BATCHES", "BENCH_TRAIN_SIZE",
               "BENCH_TRAIN_SCANK", "BENCH_CASES", "BENCH_PALLAS",
               "BENCH_KREP", "BENCH_POOLER")


class Stop(Exception):
    """Raised by a recorder to end a script's ``main`` early."""


def script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_env(monkeypatch, env: dict):
    for k in BENCH_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def same_cfg(port, ref):
    """The port's config holds every field of the reference's, equal."""
    got, want = fields(port), fields(ref)
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want


class FakeJit:
    """``jax.jit`` in place: records the function, has no ``lower`` (the
    script then reports no FLOPs) and returns a float32 0 for every
    call."""

    def __init__(self, fn, **kw):
        self.fn = fn

    def __call__(self, *a, **kw):
        return np.float32(0.0)


PACKAGES = ("roadsurf_tpu", "roadsurf_tpu_torch")


@functools.cache
def import_every_module():
    """Imports every module of both packages, once a process."""
    for name in PACKAGES:
        pkg = importlib.import_module(name)
        for info in pkgutil.walk_packages(pkg.__path__, name + "."):
            importlib.import_module(info.name)


class Fakes:
    """The one way these tests fake a global of JAX or numpy, or a
    function of the reference (``set``), through a ``pytest.MonkeyPatch``.

    A module imported while a fake is in place binds it for good: the
    ``functools.partial(jax.jit, ...)`` decorators of
    ``roadsurf_tpu/ops/roi_align_pallas.py``, imported by a script's
    ``main`` under ``FakeJit``, left every later pooler call of the
    process returning 0.0. So before the first fake, every module of both
    packages is imported with the real globals. ``undo`` takes the fakes
    back and then fails if a module of either package, or one imported
    while the fakes were in place, still holds a fake, an object made by
    a fake class or a ``functools.partial`` of either, or if anything else
    (a cache of jitted functions) keeps an object made by a fake class.
    """

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.fakes, self.classes, self.made = [], [], []
        self.modules_before = None

    def set(self, target, name, value):
        if self.modules_before is None:
            import_every_module()
            self.modules_before = set(sys.modules)
        if isinstance(value, type):
            cls, made = value, self.made

            def value(*a, **kw):
                obj = cls(*a, **kw)
                made.append(weakref.ref(obj))
                return obj

            self.classes.append(cls)
        self.fakes.append(value)
        self.monkeypatch.setattr(target, name, value)

    def _is_fake(self, v) -> bool:
        if isinstance(v, functools.partial):
            v = v.func
        return any(v is f for f in self.fakes + self.classes) \
            or isinstance(v, tuple(self.classes))

    def undo(self):
        self.monkeypatch.undo()
        if self.modules_before is None:
            return
        bound = [f"{name}.{attr}" for name, mod in list(sys.modules.items())
                 if name.split(".")[0] in PACKAGES
                 or name not in self.modules_before
                 for attr, v in list(getattr(mod, "__dict__", {}).items())
                 if self._is_fake(v)]
        assert not bound, f"fakes still bound after undo: {bound}"
        # a failed test's traceback (sys.last_value) keeps its frames
        if any(r() is not None for r in self.made) \
                and getattr(sys, "last_value", None) is None:
            gc.collect()
            kept = [type(obj).__name__ for obj in (r() for r in self.made)
                    if obj is not None]
            assert not kept, f"objects of fake classes still held: {kept}"


@pytest.fixture
def fakes(monkeypatch):
    """``Fakes`` on the test's ``monkeypatch``, undone and checked at
    teardown."""
    f = Fakes(monkeypatch)
    yield f
    f.undo()


def table_rows(out: str, head: str) -> list:
    """The first column of the table printed after the line ``head``
    starts with."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith(head))
    return [re.split(r"\s{2,}", ln.strip())[0]
            for ln in lines[start + 1:] if ln.strip()]


# ---------------------------------------------------------------------------
# 1. the knobs

KNOB_SETTINGS = [
    {}, {"BENCH_PROFILE": "parity"},
    {"BENCH_TOPK": "64", "BENCH_BATCH": "8", "BENCH_STEPS": "2"},
    {"BENCH_INT8": "1"},
    {"BENCH_INT8": "1", "BENCH_INT8_PYR": "0",
     "BENCH_INT8_SCOPE": "backbone"},
    {"BENCH_PROFILE": "parity", "BENCH_INT8": "1"},
]


def _reference_settings(monkeypatch, fakes, capsys, env: dict) -> dict:
    """The script's config, batch, steps and calibration, its ``main``
    stopped at its first device_put."""
    seen = {}

    def init_params(key, cfg):
        seen["cfg"] = cfg
        return {}

    def prepare(params, cal, cfg, *a, **kw):
        seen["cal"] = (cal.shape, cal.dtype, int(cal.sum()))
        return {}

    def device_put(*a, **kw):
        raise Stop

    set_env(monkeypatch, env)
    fakes.set(j_models, "init_params", init_params)
    fakes.set(j_quant, "prepare_quantized", prepare)
    fakes.set(jax, "device_put", device_put)
    with pytest.raises(Stop):
        script("profile_stages").main()
    err = capsys.readouterr().err
    m = re.search(r"batch=(\d+), steps=(\d+)", err)
    seen["batch"], seen["steps"] = int(m.group(1)), int(m.group(2))
    return seen


@pytest.mark.parametrize("env", KNOB_SETTINGS)
def test_the_knobs_give_the_scripts_config(monkeypatch, fakes, capsys,
                                           env):
    want = _reference_settings(monkeypatch, fakes, capsys, env)
    got = profile_stages.settings(env)
    same_cfg(got["cfg"], want["cfg"])
    assert (got["batch"], got["steps"]) == (want["batch"], want["steps"])
    if got["cfg"].int8_scope:
        cal = np.random.default_rng(1).integers(
            0, 255, (profile_stages.CAL_TILES, profile_stages.TILE,
                     profile_stages.TILE, 3), dtype=np.uint8)
        assert want["cal"] == (cal.shape, cal.dtype, int(cal.sum()))
    else:
        assert "cal" not in want


@pytest.mark.parametrize("sel", ["", "backbone,+fpn",
                                 "+mask_head=FULL,stem,no-such-stage"])
def test_the_rows_are_the_scripts(monkeypatch, fakes, capsys, sel):
    set_env(monkeypatch, {"BENCH_BATCH": "1", "BENCH_STEPS": "1",
                          "BENCH_STAGES": sel})
    fakes.set(j_models, "init_params", lambda key, cfg: {})
    fakes.set(jax, "jit", FakeJit)
    script("profile_stages").main()
    want = table_rows(capsys.readouterr().out, "stage ")
    got = profile_stages.selected(profile_stages.STAGE_NAMES, sel)
    assert got == want
    assert len(want) == {"": 9}.get(sel, 2)


# ---------------------------------------------------------------------------
# 2. the stages against the JAX functions they compose

def _reference_stages(params, cfg, images) -> list:
    """The script's stage bodies (bf16 there; the config's float32 here)
    on the non-int8 path."""
    dtype = jnp.float32
    S = cfg.min_size_test
    anchors = all_level_anchors(S, cfg.fpn_strides, cfg.anchor_sizes,
                                cfg.anchor_aspect_ratios, cfg.anchor_offset)
    gate_geom = [(cfg.num_anchors, cfg.anchor_aspect_ratios, st, sz)
                 for st, sz in zip(cfg.fpn_strides, cfg.anchor_sizes)]
    x = j_pre(images, cfg, S).astype(dtype)
    stem = j_max_pool(j_conv_bn(x, params["backbone"]["stem"], stride=2,
                                dtype=dtype), 3, 2)
    res = j_resnet(params["backbone"], x, dtype)
    feats = j_ff(params, x, cfg, dtype)
    logits, deltas = j_rpn(params["rpn"], feats, cfg.num_anchors, dtype)
    props, pscores = j_select(
        logits, deltas, anchors, S, cfg.rpn_pre_nms_topk_test,
        cfg.rpn_post_nms_topk_test, cfg.rpn_nms_thresh,
        fast_nms=cfg.fast_nms, local_max_gate=cfg.rpn_local_max_gate,
        gate_geom=gate_geom)
    cl, bd = j_box(params["box_head"], feats[:4], props, cfg, dtype)
    dets = j_dets(cl, bd, props, pscores, cfg, S)
    ml = j_mask(params["mask_head"], feats[:4], dets["boxes"], cfg, dtype)
    full = dict(dets, mask_logits=jnp.take_along_axis(
        ml, dets["classes"][:, :, None, None, None], axis=-1)[..., 0])
    return [x, stem, res, feats, (logits, deltas), (props, pscores),
            (cl, bd), dets, full]


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _close_maps(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def _close_dets(got: dict, ref: dict):
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    assert got["valid"].any()
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(ref["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"], atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               atol=1e-6)


@pytest.fixture(scope="module")
def narrow():
    """(JAX tree, JAX config, port config, two 64 px tiles)."""
    jcfg = j_narrow_cfg(SIDE)
    tree = narrow_tree(jcfg)
    imgs = np.random.default_rng(1).integers(0, 255, (2, SIDE, SIDE, 3),
                                             np.uint8)
    return tree, jcfg, _narrow_port_cfg(), imgs


def test_each_stage_equals_the_jax_functions_it_composes(narrow):
    tree, jcfg, tcfg, imgs = narrow
    ref = _reference_stages(tree, jcfg, jnp.asarray(imgs))
    state = profile_stages.model_state(tcfg, torch.device("cpu"), SIDE,
                                       from_jax_params(tree))
    x = torch.from_numpy(imgs)
    with torch.inference_mode():
        got = [fn(x) for _, fn in profile_stages.stages(state, tcfg)]
    _close_maps(got[0].numpy(), ref[0])
    _close_maps(_nhwc(got[1]), ref[1])
    assert list(got[2]) == list(ref[2])
    for k in ref[2]:
        _close_maps(_nhwc(got[2][k]), ref[2][k])
    for g, r in zip(got[3], ref[3], strict=True):
        _close_maps(_nhwc(g), r)
    for g_l, r_l in zip(got[4], ref[4]):
        for g, r in zip(g_l, r_l, strict=True):
            _close_maps(g.float().numpy(), r)
    (gb, gs), (rb, rs) = got[5], ref[5]
    np.testing.assert_allclose(gb.numpy(), rb, atol=1e-4)
    _close_maps(gs.numpy(), rs)         # the RPN's logits, kept
    for g, r in zip(got[6], ref[6], strict=True):
        _close_maps(g.numpy(), r)
    _close_dets(got[7], ref[7])
    _close_dets(got[8], ref[8])
    np.testing.assert_allclose(got[8]["mask_logits"].numpy(),
                               ref[8]["mask_logits"], atol=1e-4)


def _parity_cfg():
    from roadsurf_tpu_torch.models.config import ModelConfig

    return replace(ModelConfig(), fpn_channels=32, box_fc_dim=64,
                   mask_conv_dim=32, min_size_test=96, max_size_test=96,
                   compute_dtype="float32", rpn_pre_nms_topk_test=200,
                   rpn_post_nms_topk_test=100, detections_per_image=20)


@pytest.mark.parametrize("case", ["fast", "fast_int8_pyramid", "parity"])
def test_the_full_row_is_the_forward_bit_for_bit(narrow, case):
    tree, _, tcfg, imgs = narrow
    side = SIDE
    if case == "fast_int8_pyramid":
        tcfg = replace(tcfg, int8_scope="full", int8_pyramid=True)
    elif case == "parity":
        from roadsurf_tpu.models.config import ModelConfig as JConfig

        tcfg = _parity_cfg()
        tree = narrow_tree(replace(JConfig(), **{
            k: getattr(tcfg, k) for k in ("fpn_channels", "box_fc_dim",
                                          "mask_conv_dim")}))
    state = profile_stages.model_state(tcfg, torch.device("cpu"), side,
                                       from_jax_params(tree))
    x = torch.from_numpy(imgs)
    with torch.inference_mode():
        full = dict(profile_stages.stages(state, tcfg))["+mask_head=FULL"](x)
        want = forward_prepared(state, x, tcfg, True, "logits")
    # the script's FULL row keeps the boxes in the frame of the resized
    # image (S); the forward reports them in the tile's, scaled by the
    # same product it takes (an exact 1 where the tile is S)
    full["boxes"] = full["boxes"] * (imgs.shape[1] / tcfg.min_size_test)
    assert set(full) == set(want)
    for k in want:
        assert torch.equal(full[k], want[k]), k
    assert want["valid"].any()


def test_the_tool_runs_and_raises_without_a_card(narrow, capsys):
    _, _, tcfg, _ = narrow
    rows = profile_stages.run(env={"BENCH_STAGES": "stem,+mask_head=FULL"},
                              device="cpu", cfg=tcfg, batch=2, steps=1,
                              tile=SIDE)
    assert [r["stage"] for r in rows] == ["stem", "+mask_head=FULL"]
    assert rows[1]["gflop_per_tile"] > rows[0]["gflop_per_tile"] > 0
    assert table_rows(capsys.readouterr().out, "stage ") == [
        "stem", "+mask_head=FULL"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_stages.run(env={}, cfg=tcfg, batch=2, steps=1)
