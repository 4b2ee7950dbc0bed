"""``tools/profile_proposals.py``, ``tools/bench_proposals.py`` and
``tools/profile_heads.py`` against the reference's scripts of the same
names, on the CPU.

1. The rows: each script's ``main`` runs at B=1 with ``jax.jit`` replaced
   by a recorder (and the heads' weights and calibration by recorders):
   its row names and the shapes it prints (levels, R, D) are the tool's,
   and so is the model config the heads' script builds, field for field.
   Each tool's knobs and their defaults are the script's
   (``test_torch_measure_training.py::test_the_tools_read_the_scripts_
   knobs``).
2. The sub-stages: on the tool's own inputs (B=2, the fast profile's five
   levels at 256 px), each row of the proposal tools equals the JAX
   functions the script's row composes: top-k values and the gathered
   anchors and deltas (so the indices) exact, decoded boxes within rtol
   1e-6 and 1e-4 px (``exp`` by ulps), the local-max gate, the NMS keep
   sets, and the proposals exact.
3. The heads' rows, on the reference's weights and quant tree (bridged),
   against the JAX functions they call, eagerly: the poolers within
   1e-5·max|ref| of the reference's XLA pooler on the levels dequantized
   to bf16 taps and pooled in float32 (the port's rule; the heads'
   reference pools so through ``f32_pooling`` of ``test_torch_port_quant_
   forward.py``), the int8 backbone and FPN exact (int8 arithmetic in
   float32 is exact), the heads' outputs within the int8 forward's
   tolerances (``test_torch_port_quant_forward.py``: 1e-4; mask logits
   5e-3).
"""

from __future__ import annotations

import re
from dataclasses import replace

import numpy as np
import torch

import jax
import jax.numpy as jnp

import roadsurf_tpu.models as j_models
import roadsurf_tpu.models.quant as j_quant
from roadsurf_tpu.models import fast_profile as j_fast
from roadsurf_tpu.models.anchors import all_level_anchors, apply_deltas, \
    clip_boxes
from roadsurf_tpu.models.roi_heads import box_head_forward as j_box, \
    mask_head_forward as j_mask
from roadsurf_tpu.models.rpn import _local_max_gate as j_gate, \
    select_proposals as j_select
from roadsurf_tpu.ops.nms import NEG_INF, nms_sweep as j_sweep
from roadsurf_tpu.ops.roi_align import roi_align_multilevel as j_pool
from roadsurf_tpu_torch.tools import bench_proposals, profile_heads, \
    profile_proposals
from roadsurf_tpu_torch.utils.weights import from_jax_params, from_jax_quant
from test_torch_measure_stages import FakeJit, fakes, same_cfg, script, \
    set_env, table_rows  # noqa: F401
from test_torch_port_model import narrow_cfg as j_narrow_cfg, narrow_tree
from test_torch_port_quant_forward import f32_pooling  # noqa: F401

torch.set_num_threads(1)

B = 2


# ---------------------------------------------------------------------------
# 1. rows

def test_profile_proposals_rows_are_the_scripts(monkeypatch, fakes, capsys):
    set_env(monkeypatch, {"BENCH_BATCH": "1", "BENCH_STEPS": "1"})
    fakes.set(jax, "jit", FakeJit)
    script("profile_proposals").main()
    out = capsys.readouterr()
    assert table_rows(out.out, "sub-stage") \
        == list(profile_proposals.ROW_NAMES)
    levels = eval(re.search(r"levels=(\[[^\]]*\])", out.err).group(1))
    cfg = profile_proposals.settings({})["cfg"]
    assert profile_proposals.level_sizes(cfg) == levels


def test_bench_proposals_rows_are_the_scripts(monkeypatch, fakes, capsys):
    set_env(monkeypatch, {"BENCH_BATCH": "1", "BENCH_STEPS": "1"})
    fakes.set(jax, "jit", FakeJit)
    script("bench_proposals").main()
    out = capsys.readouterr().out
    levels = eval(re.search(r"levels (\[[^\]]*\])", out).group(1))
    rows = [ln.split()[0] for ln in out.splitlines() if "ms/batch" in ln]
    assert rows == list(bench_proposals.ROW_NAMES)
    cfg = bench_proposals.settings({})["cfg"]
    assert bench_proposals.level_sizes(cfg) == levels


def test_profile_heads_rows_and_config_are_the_scripts(monkeypatch, fakes,
                                                      capsys):
    seen = {}

    def init_params(key, cfg):
        seen["cfg"] = cfg
        return {}

    def prepare(params, cal, cfg, *a, **kw):
        seen["cal"] = (cal.shape, int(cal.sum()))
        return {"pyr": {"out_sa": None, "res_sa": None}}

    set_env(monkeypatch, {"BENCH_BATCH": "1", "BENCH_STEPS": "1",
                          "BENCH_TOPK": "16"})
    fakes.set(j_models, "init_params", init_params)
    fakes.set(j_quant, "prepare_quantized", prepare)
    fakes.set(jax, "jit", FakeJit)
    script("profile_heads").main()
    out = capsys.readouterr()
    got = profile_heads.settings({"BENCH_TOPK": "16"})["cfg"]
    same_cfg(got, seen["cfg"])
    cal = np.random.default_rng(1).integers(0, 255, (8, 256, 256, 3),
                                            dtype=np.uint8)
    assert seen["cal"] == (cal.shape, int(cal.sum()))
    assert table_rows(out.out, "sub-stage") == profile_heads.row_names(got)
    assert f"R={got.rpn_post_nms_topk_test} D={got.detections_per_image}" \
        in out.err


# ---------------------------------------------------------------------------
# 2. the proposal sub-stages against the script's JAX rows

def _jax_rows(cfg, logits, deltas, gate: bool) -> dict:
    """The scripts' row bodies (exact top-k: the CPU's approx_max_k)."""
    S = cfg.min_size_test
    pre, post = cfg.rpn_pre_nms_topk_test, cfg.rpn_post_nms_topk_test
    anchors = all_level_anchors(S, cfg.fpn_strides, cfg.anchor_sizes,
                                cfg.anchor_aspect_ratios, cfg.anchor_offset)
    geom = [(cfg.num_anchors, cfg.anchor_aspect_ratios, st, sz)
            for st, sz in zip(cfg.fpn_strides, cfg.anchor_sizes)]
    rows = {}
    if gate:
        logits = [j_gate(lg, *geom[l], cfg.rpn_nms_thresh)
                  for l, lg in enumerate(logits)]
        rows["gate"] = logits
    sel = [jax.lax.top_k(lg.astype(jnp.float32), min(pre, lg.shape[1]))
           for lg in logits]
    rows["topk"] = [s for s, _ in sel]
    rows["gather"] = []
    lv = []
    for (sc, idx), dl, an in zip(sel, deltas, anchors):
        sa = jnp.asarray(an, jnp.float32)[idx]
        sd = jnp.take_along_axis(dl.astype(jnp.float32), idx[..., None],
                                 axis=1)
        rows["gather"] += [sa, sd]
        boxes = clip_boxes(apply_deltas(sd, sa), S, S)
        ok = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
        lv.append((boxes, jnp.where(ok, sc, NEG_INF)))
    rows["decode"] = [x for p in lv for x in p]
    kb, ks = [], []
    for b_l, s_l in lv:
        k = min(post, b_l.shape[1])
        top_s, keep_i = jax.vmap(lambda b, s: j_sweep(
            b, s, cfg.rpn_nms_thresh, k))(b_l, s_l)
        kb.append(jnp.take_along_axis(b_l, keep_i[..., None], axis=1))
        ks.append(top_s)
    rows["nms"] = kb + ks
    boxes, scores = jnp.concatenate(kb, 1), jnp.concatenate(ks, 1)
    ps, ti = jax.lax.top_k(scores, post)
    rows["full"] = [jnp.take_along_axis(boxes, ti[..., None], axis=1), ps]
    return rows


def _same(got, ref, boxes: bool = False):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = g.float().numpy(), np.asarray(r, np.float32)
        if boxes:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, r)


def _port_rows(mod, logits, deltas) -> dict:
    cfg = mod.settings({})["cfg"]
    with torch.inference_mode():
        return {n: fn(logits, deltas) for n, fn in mod.stages(
            cfg, torch.device("cpu"))}


def test_profile_proposals_rows_equal_the_scripts_jax_rows():
    cfg = profile_proposals.settings({})["cfg"]
    sizes = profile_proposals.level_sizes(cfg)
    logits, deltas = profile_proposals.rpn_outputs(
        np.random.default_rng(0), B, sizes, torch.device("cpu"))
    jl = [jnp.asarray(l.float().numpy()).astype(jnp.bfloat16) for l in logits]
    jd = [jnp.asarray(d.float().numpy()).astype(jnp.bfloat16) for d in deltas]
    ref = _jax_rows(j_fast(post_nms_topk=32), jl, jd, gate=False)
    got = _port_rows(profile_proposals, logits, deltas)
    names = profile_proposals.ROW_NAMES
    _same(got[names[1]], ref["topk"])
    _same(got[names[2]], ref["gather"])
    _same(got[names[3]][0::2], ref["decode"][0::2], boxes=True)
    _same(got[names[3]][1::2], ref["decode"][1::2])
    _same(got[names[4]], ref["nms"], boxes=True)
    _same(got[names[5]], ref["full"], boxes=True)


def test_bench_proposals_rows_equal_the_scripts_jax_rows():
    cfg = bench_proposals.settings({})["cfg"]
    jcfg = j_fast(post_nms_topk=32)
    ns = bench_proposals.level_sizes(cfg)
    logits, deltas = profile_proposals.rpn_outputs(
        np.random.default_rng(0), B, ns, torch.device("cpu"), 0.2)
    jl = [jnp.asarray(l.float().numpy()).astype(jnp.bfloat16) for l in logits]
    jd = [jnp.asarray(d.float().numpy()).astype(jnp.bfloat16) for d in deltas]
    ref = _jax_rows(jcfg, jl, jd, gate=True)
    got = _port_rows(bench_proposals, logits, deltas)
    _same(got["gate"], ref["gate"])
    _same([s for s, _ in got["topk"]], ref["topk"])
    _same([b for b, _ in got["decode"]], ref["decode"][0::2], boxes=True)
    _same([s for _, s in got["decode"]], ref["decode"][1::2])
    S = jcfg.min_size_test
    anchors = all_level_anchors(S, jcfg.fpn_strides, jcfg.anchor_sizes,
                                jcfg.anchor_aspect_ratios,
                                jcfg.anchor_offset)
    geom = [(jcfg.num_anchors, jcfg.anchor_aspect_ratios, st, sz)
            for st, sz in zip(jcfg.fpn_strides, jcfg.anchor_sizes)]
    want = j_select(jl, jd, anchors, S, jcfg.rpn_pre_nms_topk_test,
                    jcfg.rpn_post_nms_topk_test, jcfg.rpn_nms_thresh,
                    fast_nms=True, local_max_gate=True, gate_geom=geom)
    _same(list(got["full"]), list(want), boxes=True)


# ---------------------------------------------------------------------------
# 3. the heads' rows

def test_profile_heads_rows_equal_the_jax_functions(f32_pooling):
    jcfg = replace(j_narrow_cfg(64), int8_scope="full", int8_pyramid=True)
    tcfg = profile_heads.settings({})["cfg"]
    tcfg = replace(tcfg, fpn_channels=32, box_fc_dim=64, mask_conv_dim=32,
                   min_size_test=64, max_size_test=64,
                   compute_dtype="float32")
    tree = narrow_tree(jcfg)
    cal = np.random.default_rng(1).integers(0, 255, (8, 64, 64, 3),
                                            dtype=np.uint8)
    jq = jax.device_get(j_quant.prepare_quantized(tree, cal, jcfg))
    state = dict(from_jax_params(tree), quant=from_jax_quant(jq))
    from roadsurf_tpu_torch.utils.weights import state_to

    state = state_to(state, torch.device("cpu"), torch.float32)
    feats, props, imgs = profile_heads.inputs(
        np.random.default_rng(0), tcfg, B, torch.device("cpu"), 64)
    with torch.inference_mode():
        got = {n: fn(feats, props, imgs)
               for n, fn in profile_heads.stages(state, tcfg)}
    jf = [jnp.asarray(f.numpy()) for f in feats]
    jp, ji = jnp.asarray(props.numpy()), jnp.asarray(imgs.numpy())
    scales = jq["pyr"]["out_sa"]
    D = jcfg.detections_per_image
    names = profile_heads.row_names(tcfg)

    # the int8 levels dequantized to bf16 taps, pooled in float32: the
    # port's rule, which the heads' reference takes through f32_pooling
    jdq = [(f.astype(jnp.float32) * scales[i]).astype(jnp.bfloat16)
           .astype(jnp.float32) for i, f in enumerate(jf)]

    def pool(boxes, P):
        return j_pool(jdq, boxes, P, sampling=jcfg.pooler_sampling_ratio,
                      canonical_size=jcfg.canonical_box_size,
                      canonical_level=jcfg.canonical_level,
                      use_pallas=False)

    for name, ref in ((names[1], pool(jp, jcfg.box_pooler_resolution)),
                      (names[3], pool(jp[:, :D],
                                      jcfg.mask_pooler_resolution))):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got[name].float().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    res = j_quant.resnet_forward_int8(jq["backbone"], ji,
                                      out_sas=jq["pyr"]["res_sa"])
    for k in res:
        np.testing.assert_array_equal(
            got[names[5]][k].permute(0, 2, 3, 1).numpy(), np.asarray(res[k]))
    fpn = j_quant.fpn_forward_int8_pyr(jq["fpn"], jq["pyr"], res,
                                       jnp.float32)
    for g, r in zip(got[names[6]], fpn, strict=True):
        np.testing.assert_array_equal(g.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(r))
    cl, bd = j_box(tree["box_head"], jf, jp, jcfg, jnp.float32,
                   use_pallas=False, qp=jq["box"], feat_scales=scales)
    np.testing.assert_allclose(got[names[2]][0].numpy(), cl, atol=1e-4)
    np.testing.assert_allclose(got[names[2]][1].numpy(), bd, atol=1e-4)
    ml = j_mask(tree["mask_head"], jf, jp[:, :D], jcfg, jnp.float32,
                use_pallas=False, qp=jq["mask"], feat_scales=scales)
    np.testing.assert_allclose(got[names[4]].numpy(), ml, atol=5e-3)
