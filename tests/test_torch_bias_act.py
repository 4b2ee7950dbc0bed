"""The conv epilogue (``ops/bias_act.py``, ``csrc/bias_act.cu``) on the
CPU: what its wrapper refuses, the plain ops that the forward's units keep
wherever the kernel does not engage (the CPU, float32, grad on), its plain
version against those ops, the kernel's launches in a forward routed as
on the card, its launch counter, and its kernel's name in the benchmark's
categories. The kernel itself runs in ``test_torch_bias_act_card.py``."""

import re
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from portbench.trace import category
from roadsurf_tpu_torch.models import ModelConfig, fast_profile, \
    init_params, prepare_quantized
from roadsurf_tpu_torch.models.fpn import fpn_forward, upsample2x_nearest
from roadsurf_tpu_torch.models.mask_rcnn import forward_prepared
from roadsurf_tpu_torch.models.resnet import bottleneck, conv
from roadsurf_tpu_torch.models.roi_heads import _pool, mask_head_forward
from roadsurf_tpu_torch.models.rpn import rpn_head_forward
from roadsurf_tpu_torch.ops import add_launch_counts, launch_counts, \
    reset_launch_counts
from roadsurf_tpu_torch.ops import bias_act as epilogue
from roadsurf_tpu_torch.ops import cuda_build
from roadsurf_tpu_torch.utils.weights import from_jax_params, state_to

CL = torch.channels_last


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype \
        and torch.equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# the forward's units as they were before the epilogue: the plain ops

def plain_conv(x, p, stride=1, relu=False):
    k = p["w"].shape[-1]
    y = F.conv2d(x, p["w"], p["b"], stride=stride, padding=k // 2)
    return torch.relu_(y) if relu else y


def plain_bottleneck(x, p, stride=1):
    out = plain_conv(x, p["conv1"], stride, relu=True)
    out = plain_conv(out, p["conv2"], relu=True)
    out = plain_conv(out, p["conv3"])
    sc = plain_conv(x, p["shortcut"], stride) if "shortcut" in p else x
    return torch.relu_(out + sc)


def plain_fpn(params, feats):
    names = ["res2", "res3", "res4", "res5"]
    laterals = [plain_conv(feats[n], params[f"lateral{i + 2}"])
                for i, n in enumerate(names)]
    tds = [None] * 4
    tds[3] = laterals[3]
    for i in (2, 1, 0):
        tds[i] = laterals[i] + upsample2x_nearest(tds[i + 1])
    outs = [plain_conv(tds[i].contiguous(memory_format=CL),
                       params[f"output{i + 2}"]) for i in range(4)]
    outs.append(outs[3][:, :, ::2, ::2].contiguous(memory_format=CL))
    return outs


def plain_rpn_head(params, feats):
    out = []
    for f in feats:
        t = plain_conv(f, params["conv"], relu=True)
        out += [plain_conv(t, params["objectness"]),
                plain_conv(t, params["deltas"])]
    return out


def plain_mask_head(params, feats, boxes, cfg):
    B, D = boxes.shape[:2]
    P = cfg.mask_pooler_resolution
    x = _pool(feats, boxes, P, cfg, None).reshape(B * D, P, P, -1) \
        .to(params["conv1"]["w"].dtype).permute(0, 3, 1, 2)
    for i in range(cfg.mask_num_conv):
        x = plain_conv(x, params[f"conv{i + 1}"], relu=True)
    p = params["deconv"]
    x = torch.relu_(F.conv_transpose2d(x, p["w"], p["b"], stride=2))
    p = params["predictor"]
    x = F.conv2d(x, p["w"]).float() + p["b"].float()[:, None, None]
    return x.permute(0, 2, 3, 1).reshape(B, D, 2 * P, 2 * P,
                                         cfg.num_classes)


# ---------------------------------------------------------------------------
# small units and inputs

def unit(g, cout, cin, k, dtype, grad):
    w = (torch.randn((cout, cin, k, k), generator=g)
         / (cin * k * k) ** 0.5).to(dtype).contiguous(memory_format=CL)
    b = (0.1 * torch.randn(cout, generator=g)).to(dtype)
    return {"w": w.requires_grad_(grad), "b": b.requires_grad_(grad)}


def nchw(g, shape, dtype):
    return torch.randn(shape, generator=g).to(dtype) \
        .contiguous(memory_format=CL)


MASK_CFG = replace(fast_profile(), mask_conv_dim=8, mask_num_conv=4)


def case(kind, dtype, grad):
    """(the unit under test, its plain version, its convs) on small
    inputs."""
    g = torch.Generator().manual_seed(7)
    if kind in ("conv", "conv_relu"):
        x, p = nchw(g, (2, 8, 9, 7), dtype), unit(g, 16, 8, 3, dtype, grad)
        relu = kind == "conv_relu"
        return (lambda: conv(x, p, 2, relu=relu),
                lambda: plain_conv(x, p, 2, relu=relu), 1)
    if kind.startswith("bottleneck"):
        cin = 16 if kind == "bottleneck_identity" else 8
        x = nchw(g, (2, cin, 9, 9), dtype)
        p = {"conv1": unit(g, 4, cin, 1, dtype, grad),
             "conv2": unit(g, 4, 4, 3, dtype, grad),
             "conv3": unit(g, 16, 4, 1, dtype, grad)}
        stride = 1
        if kind == "bottleneck_shortcut":
            p["shortcut"] = unit(g, 16, cin, 1, dtype, grad)
            stride = 2
        return (lambda: bottleneck(x, p, stride),
                lambda: plain_bottleneck(x, p, stride),
                4 if "shortcut" in p else 3)
    if kind == "fpn":
        chans, sides = (8, 16, 32, 64), (16, 8, 4, 2)
        feats = {f"res{i + 2}": nchw(g, (2, c, s, s), dtype)
                 for i, (c, s) in enumerate(zip(chans, sides))}
        params = {}
        for i, c in enumerate(chans):
            params[f"lateral{i + 2}"] = unit(g, 8, c, 1, dtype, grad)
            params[f"output{i + 2}"] = unit(g, 8, 8, 3, dtype, grad)
        return (lambda: fpn_forward(params, feats),
                lambda: plain_fpn(params, feats), 8)
    if kind == "rpn_head":
        feats = [nchw(g, (2, 8, s, s), dtype) for s in (8, 4, 2, 1)]
        params = {"conv": unit(g, 8, 8, 3, dtype, grad),
                  "objectness": unit(g, 3, 8, 1, dtype, grad),
                  "deltas": unit(g, 12, 8, 1, dtype, grad)}

        def run():
            lg, dl = rpn_head_forward(params, feats)
            return [t for pair in zip(lg, dl) for t in pair]

        def plain():
            out = plain_rpn_head(params, feats)
            return [t.permute(0, 2, 3, 1).reshape(2, -1) if i % 2 == 0
                    else t.permute(0, 2, 3, 1).reshape(2, -1, 4)
                    for i, t in enumerate(out)]

        return run, plain, 3 * len(feats)
    assert kind == "mask_head"
    cfg, C, M = MASK_CFG, 8, MASK_CFG.mask_conv_dim
    feats = [torch.randn((2, s, s, C), generator=g).to(dtype)
             for s in (16, 8, 4, 2)]
    boxes = torch.tensor([[[4.0, 4.0, 40.0, 30.0], [10.0, 2.0, 60.0, 62.0]],
                          [[0.0, 0.0, 64.0, 64.0], [20.0, 8.0, 28.0, 50.0]]])
    params = {f"conv{i + 1}": unit(g, M, C if i == 0 else M, 3, dtype, grad)
              for i in range(cfg.mask_num_conv)}
    w = (torch.randn((M, M, 2, 2), generator=g) / M ** 0.5).to(dtype)
    params["deconv"] = {"w": w.requires_grad_(grad),
                        "b": (0.1 * torch.randn(M, generator=g)).to(dtype)
                        .requires_grad_(grad)}
    params["predictor"] = unit(g, cfg.num_classes, M, 1, dtype, grad)
    return (lambda: mask_head_forward(params, feats, boxes, cfg),
            lambda: plain_mask_head(params, feats, boxes, cfg),
            cfg.mask_num_conv + 1)


NEGATIVES = {"cpu_bf16": (torch.bfloat16, False),
             "float32": (torch.float32, False),
             "grad_on": (torch.float32, True)}
KINDS = ("conv", "conv_relu", "bottleneck_shortcut", "bottleneck_identity",
         "fpn", "rpn_head", "mask_head")


@pytest.mark.parametrize("negative", list(NEGATIVES))
@pytest.mark.parametrize("kind", KINDS)
def test_units_keep_the_plain_ops_where_the_kernel_does_not_engage(
        kind, negative):
    """On the CPU, in float32 and with grad on, each unit of the forward
    returns the plain ops' tensors bit for bit, its convs counted as
    plain, none as fused and no launch."""
    dtype, grad = NEGATIVES[negative]
    run, plain, convs = case(kind, dtype, grad)
    mode = torch.enable_grad() if grad else torch.inference_mode()
    before = dict(epilogue.counts)
    launches = epilogue.launches
    with mode:
        got = run()
    after = dict(epilogue.counts)
    with mode:
        want = plain()
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    assert all(same(a, b) for a, b in zip(got, want))
    assert after["plain"] - before["plain"] == convs
    assert after["fused"] == before["fused"]
    assert epilogue.launches == launches


# ---------------------------------------------------------------------------
# the plain version against the ops it stands for

SPECIAL = (float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1e-40)


def special(g, shape):
    """bf16 values with NaN, ±0, ±inf and a subnormal at seeded places."""
    t = torch.randn(shape, generator=g)
    flat = t.view(-1)
    idx = torch.randperm(flat.numel(), generator=g)[:6 * len(SPECIAL)]
    for i, j in enumerate(idx):
        flat[j] = SPECIAL[i % len(SPECIAL)]
    return t.to(torch.bfloat16)


@pytest.mark.parametrize("C", [3, 12, 64])
@pytest.mark.parametrize("kind", ["bias", "bias_relu", "tail_shortcut",
                                  "tail_identity", "lateral"])
def test_the_plain_version_is_the_ops_it_replaces(kind, C):
    """``bias_act_ref`` computes what the units' ops compute, NaN and ±0
    included: an in-place broadcast bias add, then the residual sum or the
    upsampled coarser level, then ``relu_``."""
    g = torch.Generator().manual_seed(C)
    shape = (2, C, 6, 4)
    y = special(g, shape).contiguous(memory_format=CL)
    b = special(g, (C,))
    kw, want = {}, y.clone().add_(b.view(1, -1, 1, 1))
    if kind == "tail_shortcut":
        r, rb = special(g, shape).contiguous(memory_format=CL), \
            special(g, (C,))
        kw = {"residual": r, "residual_bias": rb, "relu": True}
        want = torch.relu_(want + r.clone().add_(rb.view(1, -1, 1, 1)))
    elif kind == "tail_identity":
        r = special(g, shape).contiguous(memory_format=CL)
        kw = {"residual": r, "relu": True}
        want = torch.relu_(want + r)
    elif kind == "lateral":
        t = special(g, (2, C, 3, 2)).contiguous(memory_format=CL)
        kw = {"coarser": t}
        want = want + upsample2x_nearest(t)
    elif kind == "bias_relu":
        kw = {"relu": True}
        want = torch.relu_(want)
    assert same(epilogue.bias_act_ref(y, b, **kw), want)


# ---------------------------------------------------------------------------
# the wrapper's checks and the kernel's name

def test_wrapper_rejects_what_the_kernel_does_not_take():
    """A CPU tensor is refused before any check; the rest on meta tensors
    (no data, no device): dtype, layout and shapes."""
    y = torch.empty((2, 16, 8, 6), dtype=torch.bfloat16) \
        .contiguous(memory_format=CL)
    b = torch.empty(16, dtype=torch.bfloat16)
    launches = epilogue.launches
    with pytest.raises(ValueError, match="CUDA"):
        epilogue.bias_act(y, b)
    ym, bm = y.to("meta"), b.to("meta")
    rm = ym.clone()
    tm = torch.empty((2, 16, 4, 3), dtype=torch.bfloat16, device="meta") \
        .contiguous(memory_format=CL)
    ok = epilogue._check
    ok(ym, bm, None, None, None)
    ok(ym, bm, rm, None, None)
    ok(ym, bm, rm, bm, None)
    ok(ym, bm, None, None, tm)
    with pytest.raises(TypeError):
        ok(ym.float(), bm.float(), None, None, None)
    with pytest.raises(TypeError):
        ok(ym, bm.float(), None, None, None)
    with pytest.raises(ValueError, match="channels_last"):
        ok(ym.contiguous(), bm, None, None, None)
    with pytest.raises(ValueError, match="bias"):
        ok(ym, bm[:8], None, None, None)
    with pytest.raises(ValueError, match="residual"):
        ok(ym, bm, rm[:1], None, None)
    with pytest.raises(ValueError, match="channels_last"):
        ok(ym, bm, rm.contiguous(), None, None)
    with pytest.raises(ValueError, match="residual_bias"):
        ok(ym, bm, None, bm, None)
    with pytest.raises(ValueError, match="coarser"):
        ok(ym, bm, None, None, rm)
    with pytest.raises(ValueError, match="not both"):
        ok(ym, bm, rm, None, tm)
    odd = torch.empty((2, 16, 7, 6), dtype=torch.bfloat16, device="meta") \
        .contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="coarser"):
        ok(odd, bm, None, None, tm)
    wide = torch.empty((1, 1025, 2, 2), dtype=torch.bfloat16,
                       device="meta").contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="channels"):
        ok(wide, torch.empty(1025, dtype=torch.bfloat16, device="meta"),
           None, None, None)
    assert epilogue.launches == launches


def test_the_epilogue_engages_only_on_the_card_in_inference():
    """``engages`` says no for CPU tensors whatever their dtype, layout or
    grad mode, and counts each as plain (on the card it takes any layout:
    the kernel's wrapper refuses a map not in channels_last memory)."""
    x = torch.zeros((1, 8, 4, 4), dtype=torch.bfloat16) \
        .contiguous(memory_format=CL)
    before = dict(epilogue.counts)
    with torch.inference_mode():
        assert not epilogue.engages(x)
        assert not epilogue.engages(x, 2)
    assert not epilogue.engages(x.contiguous())
    assert epilogue.counts["plain"] == before["plain"] + 4
    assert epilogue.counts["fused"] == before["fused"]


def test_the_kernel_counts_as_elementwise_in_the_benchmark():
    """The kernel's name puts it in ``portbench.trace.category``'s
    "elementwise", where its bytes belong, and in no conv, gemm or copy
    category; its library is built with the other kernels."""
    src = (cuda_build.CSRC / "bias_act.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert names == ["bias_act_elementwise_kernel"]
    for vec in (8, 1):
        for mode in range(4):
            for relu in ("true", "false"):
                demangled = (
                    f"void (anonymous namespace)::{names[0]}<{vec}, {mode}, "
                    f"{relu}>(unsigned short*, unsigned short const*, "
                    f"unsigned short const*, unsigned short const*, long "
                    f"long, int, int, int)")
                assert category(demangled) == "elementwise"
    assert "bias_act" in cuda_build.SOURCES


def test_the_launch_counter_is_the_registrys():
    """The kernel's launches count under ``ops.launch_counts`` as K1-K5's
    do: reset with theirs, added to by a CUDA graph's replay."""
    assert launch_counts()["bias_act"] == epilogue.launches
    add_launch_counts({"bias_act": 77})
    assert epilogue.launches >= 77
    reset_launch_counts()
    assert epilogue.launches == 0
    assert set(epilogue.counts) == {"fused", "plain"}


# ---------------------------------------------------------------------------
# the kernel's launches in a forward, the conv routing as on the card

PROFILES = {"fast": (fast_profile(post_nms_topk=32), chip_smoke.EPILOGUE),
            "parity": (replace(ModelConfig(), min_size_test=64),
                       chip_smoke.EPILOGUE),
            "fast_int8": (replace(fast_profile(post_nms_topk=32),
                                  **chip_smoke.INT8), 0)}


@pytest.mark.parametrize("profile", list(PROFILES))
def test_a_forward_launches_the_kernel_as_chip_smoke_expects(
        monkeypatch, profile):
    """A bf16 inference forward with the engage condition's device check
    lifted and the kernel stood in for by its plain version on the CPU:
    ``chip_smoke.EPILOGUE`` launches (77) at either profile's widths, one
    for each conv but the 4 shortcuts (they ride their blocks' tails),
    none through the plain ops; the int8 stack's forward, none at all."""
    cfg, want = PROFILES[profile]

    def engages(x, convs=1):
        on = x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
        epilogue.counts["fused" if on else "plain"] += convs
        return on

    def stand_in(y, bias, relu=False, residual=None, residual_bias=None,
                 coarser=None):
        epilogue._check(y, bias, residual, residual_bias, coarser)
        epilogue.launches += 1
        return epilogue.bias_act_ref(y, bias, relu, residual,
                                     residual_bias, coarser)

    state = from_jax_params(init_params(cfg, torch.Generator()
                                        .manual_seed(0)))
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    state = state_to(state, "cpu", torch.bfloat16)
    if cfg.int8_scope:
        state["quant"] = prepare_quantized(state, images, cfg, device="cpu")
    monkeypatch.setattr(epilogue, "engages", engages)
    monkeypatch.setattr(epilogue, "bias_act", stand_in)
    before, launches = dict(epilogue.counts), epilogue.launches
    with torch.inference_mode():
        out = forward_prepared(state, images, cfg, True, "logits")
    assert epilogue.launches - launches == want
    assert epilogue.counts["plain"] == before["plain"]
    assert epilogue.counts["fused"] - before["fused"] == \
        (want + 4 if want else 0)
    assert all(bool(torch.isfinite(out[k].float()).all())
               for k in ("boxes", "scores", "mask_logits"))
