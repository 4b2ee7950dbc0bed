"""ViTDet's LayerNorms (``ops/layer_norm.py``) on the CPU: the plain
version in each mode against the PyTorch ops it replaces, which calls take
the kernel, the kernel wrapper's refusals, the counters and the kernel's
name as the benchmark reads it, and ``models/vit.py``'s blocks, pyramid and
LN heads against their form before the LN pass (each LN and its neighbours
as separate ATen ops), bit for bit. The kernel itself runs only on the card
(``tests/test_torch_layer_norm_card.py``).
"""

import re
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from portbench import harness, modelgen, spec
from portbench.trace import category
from roadsurf_tpu_torch.models import roi_heads, vit
from roadsurf_tpu_torch.models.config import vitdet_b
from roadsurf_tpu_torch.models.mask_rcnn import prepare_state
from roadsurf_tpu_torch.ops import add_launch_counts, cuda_build, \
    launch_counts, reset_launch_counts
from roadsurf_tpu_torch.ops import attention as att
from roadsurf_tpu_torch.ops import layer_norm as lnm

torch.set_num_threads(1)

EPS = 1e-6


def _affine(g, C):
    return (1 + 0.1 * torch.randn(C, generator=g),
            0.1 * torch.randn(C, generator=g))


def _padded_slice(g, B, H, W, C, Hp, Wp):
    """A (B, H, W, C) view of a (B, Hp, Wp, C) grid: rows at the padded
    grid's strides, as a windowed block's ``o[:, :H, :W]``."""
    return torch.randn(B, Hp, Wp, C, generator=g)[:, :H, :W]


# (mode, (B, H, W, C), pad_to): each mode of the pass at a ragged grid
MODES = [("plain", (2, 5, 7, 32), None),
         ("relu", (3, 4, 4, 16), None),
         ("gelu", (2, 6, 6, 24), None),
         ("residual_strided", (2, 7, 7, 32), None),
         ("padded", (2, 7, 7, 32), (9, 9)),
         ("residual_padded", (2, 7, 8, 32), (9, 9)),
         ("residual_padded_contiguous", (1, 6, 6, 16), (6, 6))]


def _composition(x, w, b, mode, pad_to, r):
    """The ATen ops the pass replaces, in the order the forward ran them
    before: the add, ``F.layer_norm``, the activation, ``F.pad``."""
    s = x if r is None else x + r
    y = F.layer_norm(s, (s.shape[-1],), w, b, EPS)
    if mode == "relu":
        y = torch.relu(y)
    elif mode == "gelu":
        y = F.gelu(y)
    if pad_to is not None:
        H, W = s.shape[1:3]
        y = F.pad(y, (0, 0, 0, pad_to[1] - W, 0, pad_to[0] - H))
    return s, y


@pytest.mark.parametrize("mode,shape,pad_to", MODES,
                         ids=[m[0] for m in MODES])
def test_the_plain_version_is_the_ops_it_replaces(mode, shape, pad_to):
    """``layer_norm_ref`` (and ``layer_norm``, which takes it on the CPU)
    against the composition of add, LN, activation and pad in float32,
    bit for bit; the pad's rows exactly zero."""
    g = torch.Generator().manual_seed(len(mode) * 31 + sum(shape))
    B, H, W, C = shape
    x = torch.randn(shape, generator=g) * 3 + 0.5
    w, b = _affine(g, C)
    r = None
    if mode.startswith("residual"):
        r = _padded_slice(g, B, H, W, C, H + 2, W + 3) \
            if mode == "residual_strided" or mode == "residual_padded" \
            else torch.randn(shape, generator=g)
        assert r.is_contiguous() == (mode == "residual_padded_contiguous")
    act = mode if mode in ("relu", "gelu") else None
    want_s, want_y = _composition(x, w, b, mode, pad_to, r)
    for fn in (lnm.layer_norm_ref, lnm.layer_norm):
        s, y = fn(x, w, b, EPS, residual=r, act=act, pad_to=pad_to)
        assert torch.equal(s, want_s) and torch.equal(y, want_y)
    if pad_to is not None and pad_to != (H, W):
        assert y.shape == (B, *pad_to, C)
        assert not y[:, H:].any() and not y[:, :, W:].any()


def test_an_unknown_activation_raises():
    x = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="activation"):
        lnm.layer_norm_ref(x, torch.ones(8), torch.zeros(8), EPS,
                           act="silu")


def _fake(C=256, dtype=torch.bfloat16, cuda=True):
    """What ``engages`` reads of a tensor: device, dtype and shape."""
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=(2, 4, 4, C))


@pytest.mark.parametrize("kw,on", [
    ({}, True), ({"C": 768}, True), ({"C": 8}, False),
    ({"C": max(lnm.WIDTHS)}, True), ({"cuda": False}, False),
    ({"dtype": torch.float32}, False), ({"C": 12}, False),
    ({"C": max(lnm.WIDTHS) + 8}, False), ({"C": 384}, True),
    ({"C": 512}, False), ({"C": 128}, False)],
    ids=["bf16-256", "768", "8", "max", "cpu", "float32", "C12", "over-max",
         "384", "512", "128"])
def test_engages_on_the_card_in_bf16_inference_at_its_widths(kw, on):
    """The kernel takes bf16 rows on the card with grad off and C one of
    ViTDet-B's ``WIDTHS``; other widths, multiples of 8 or not, take the
    plain version. Each call counts on its side."""
    before = dict(lnm.counts)
    with torch.inference_mode():
        assert lnm.engages(_fake(**kw)) is on
    side = "fused" if on else "plain"
    assert lnm.counts[side] == before[side] + 1
    assert sum(lnm.counts.values()) == sum(before.values()) + 1


def test_grad_on_and_the_cpu_take_the_plain_version():
    """Training (grad on) takes the plain version even for bf16 rows on
    the card; on the CPU every call, bf16 or float32, with or without
    grad, runs ``F.layer_norm`` and counts as plain."""
    before = dict(lnm.counts)
    with torch.enable_grad():
        assert not lnm.engages(_fake())
    calls = []
    real = F.layer_norm

    def recording(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    F.layer_norm = recording
    try:
        x = torch.randn(1, 3, 3, 16)
        w, b = torch.ones(16), torch.zeros(16)
        with torch.inference_mode():
            lnm.layer_norm(x, w, b, EPS)
            lnm.layer_norm(x.bfloat16(), w.bfloat16(), b.bfloat16(), EPS)
        with torch.enable_grad():
            lnm.layer_norm(x.requires_grad_(), w, b, EPS, act="relu")
    finally:
        F.layer_norm = real
    assert calls == [torch.float32, torch.bfloat16, torch.float32]
    assert lnm.counts["plain"] == before["plain"] + 4
    assert lnm.counts["fused"] == before["fused"]


def _bf16(*shape, offset=0):
    t = torch.zeros(int(torch.tensor(shape).prod()) + offset,
                    dtype=torch.bfloat16)
    return t[offset:].view(shape)


@pytest.mark.parametrize("case", [
    "float32", "nchw", "misaligned", "odd_row_stride", "residual_shape",
    "w_shape", "b_float32", "C12", "over_max", "pad_small", "rows",
    "act"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    """``_check``: what a CUDA call goes through before the launch."""
    x, r = _bf16(2, 4, 5, 256), None
    w, b = _bf16(256), _bf16(256)
    act, pad_to = None, None
    err = ValueError
    if case == "float32":
        x, err = x.float(), TypeError
    elif case == "nchw":
        # the NHWC view of an NCHW map not in channels_last memory
        x = _bf16(2, 256, 4, 5).permute(0, 2, 3, 1)
    elif case == "misaligned":
        x = _bf16(2, 4, 5, 256, offset=1)
    elif case == "odd_row_stride":
        x = _bf16(2, 4, 5, 260)[..., :256]
    elif case == "residual_shape":
        r = _bf16(2, 4, 4, 256)
    elif case == "w_shape":
        w = _bf16(8)
    elif case == "b_float32":
        b, err = b.float(), TypeError
    elif case == "C12":
        x, w, b = _bf16(2, 4, 5, 12), _bf16(12), _bf16(12)
    elif case == "over_max":
        C = max(lnm.WIDTHS) + 8
        x, w, b = _bf16(1, 1, 1, C), _bf16(C), _bf16(C)
    elif case == "pad_small":
        pad_to = (3, 5)
    elif case == "rows":
        x, w, b = (torch.empty(sh, dtype=torch.bfloat16, device="meta")
                   for sh in ((2 ** 16, 2 ** 15, 1, 256), (256,), (256,)))
    elif case == "act":
        act = "silu"
    with pytest.raises(err) as info:
        lnm._check(x, w, b, r, act, pad_to)
    assert "one device" not in str(info.value)


def test_the_wrapper_takes_the_forwards_rows():
    """What the forward hands the kernel passes ``_check``: contiguous
    rows, a slice of a padded grid as the residual, the NHWC view of a
    channels_last map, a pad."""
    x, w, b = _bf16(2, 4, 5, 768), _bf16(768), _bf16(768)
    lnm._check(x, w, b, _bf16(2, 6, 7, 768)[:, :4, :5], None, (6, 7))
    nchw = _bf16(2, 384, 4, 5).contiguous(memory_format=torch.channels_last)
    lnm._check(nchw.permute(0, 2, 3, 1), _bf16(384), _bf16(384), None,
               "gelu", None)


def test_the_kernel_runs_on_cuda_tensors_only():
    x = _bf16(1, 2, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        lnm.layer_norm_rows(x, _bf16(16), _bf16(16), EPS)


def test_the_kernel_stays_out_of_the_benchmarks_categories():
    """The kernel's name holds none of ``portbench.trace.category``'s
    keys: it counts as "other", as ATen's LayerNorm did, so that
    ``forward.elementwise_us`` reads only the passes it removes; its
    library is built with the other kernels."""
    src = (cuda_build.CSRC / "layer_norm.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert names == ["layer_norm_rows_kernel"]
    for v, lanes in ((3, 32), (3, 16), (2, 16)):
        for res in ("true", "false"):
            demangled = (f"void (anonymous namespace)::{names[0]}<{v}, "
                         f"{lanes}, {res}>((anonymous namespace)::Rows)")
            assert category(demangled) == "other"
            assert category(demangled.replace(" ", "_").replace(
                "(", "_").replace(")", "_")) == "other"
    assert "layer_norm" in cuda_build.SOURCES


def test_the_launch_counter_is_the_registrys():
    assert launch_counts()["layer_norm"] == lnm.launches
    add_launch_counts({"layer_norm": 41})
    assert lnm.launches >= 41
    reset_launch_counts()
    assert lnm.launches == 0
    assert set(lnm.counts) == {"fused", "plain"}


# ---------------------------------------------------------------------------
# the model's calls against their form before the LN pass


def _old_ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["w"], p["b"], eps)


def _old_ln2d(x, p, eps):
    return _old_ln(x.permute(0, 2, 3, 1), p, eps).permute(0, 3, 1, 2)


def _old_block(x, p, cfg, window):
    """A block before the LN pass: LN, pad, attention, add, LN, MLP,
    add, each its own op."""
    B, H, W, C = x.shape
    eps = cfg.ln_eps
    h = _old_ln(x, p["norm1"], eps)
    side = window or H
    if window:
        ph, pw = -H % window, -W % window
        if ph or pw:
            h = F.pad(h, (0, 0, 0, pw, 0, ph))
    qkv = F.linear(h, p["qkv"]["w"], p["qkv"]["b"])
    o = att.attention(qkv, p["rel_pos_h"], p["rel_pos_w"], cfg.vit_heads,
                      side)
    o = F.linear(o, p["proj"]["w"], p["proj"]["b"])
    x = x + o[:, :H, :W]
    h = F.gelu(F.linear(_old_ln(x, p["norm2"], eps), p["fc1"]["w"],
                        p["fc1"]["b"]))
    return x + F.linear(h, p["fc2"]["w"], p["fc2"]["b"])


def _old_pyramid(params, x, cfg):
    f = x.permute(0, 3, 1, 2)
    eps = cfg.ln_eps
    outs = []
    for scale, name in zip(cfg.sfp_scales, vit.LEVELS):
        p = params[name]
        t = f
        if scale == 4.0:
            t = vit._deconv(F.gelu(_old_ln2d(vit._deconv(t, p["deconv1"]),
                                             p["norm"], eps)), p["deconv2"])
        elif scale == 2.0:
            t = vit._deconv(t, p["deconv1"])
        elif scale == 0.5:
            t = F.max_pool2d(t, kernel_size=2, stride=2)
        t = _old_ln2d(F.conv2d(t, p["lateral"]["w"]), p["lateral_norm"], eps)
        t = _old_ln2d(F.conv2d(t, p["output"]["w"], padding=1),
                      p["output_norm"], eps)
        outs.append(t)
    outs.append(outs[-1][:, :, ::2, ::2].contiguous(
        memory_format=torch.channels_last))
    return outs


CELL = spec.cell("vitdet-b-1024.detect-b16")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def narrow(request):
    """(config, prepared state, images, dtype) at the family's narrow
    widths (windows of 3 on an 8x8 grid, padded to 9x9)."""
    dtype = getattr(torch, request.param)
    st = dict(CELL.config["settings"], **CELL.family.NARROW,
              compute_dtype=request.param)
    cfg = harness.port_config(CELL.config, st)
    g = modelgen.generator(2 ** 31 + 27, "cpu")
    state = prepare_state(CELL.family.weights(st, g, "cpu", dtype), cfg,
                          "cpu")
    images = torch.randn((2, 3, st["min_size_test"], st["min_size_test"]),
                         generator=torch.Generator().manual_seed(27)) \
        .to(dtype).contiguous(memory_format=torch.channels_last)
    return cfg, state, images, dtype


def test_the_backbone_is_the_same_as_before(narrow):
    """The ViT's blocks, windowed (padded) and global, chained with each
    MLP's output summed in the next block's ``norm1``: the same tokens as
    before, bit for bit, block by block and at the end."""
    cfg, state, images, dtype = narrow
    bb = state["backbone"]
    with torch.inference_mode():
        pe = bb["patch_embed"]
        t = F.conv2d(images, pe["w"], pe["b"], stride=cfg.vit_patch) \
            .permute(0, 2, 3, 1)
        B, H, W, C = t.shape
        t = t + bb["pos_grid"].view(1, H, W, C)
        windows = [0 if i in cfg.vit_global_blocks else cfg.vit_window
                   for i in range(len(bb["blocks"]))]
        old = t
        for i, p in enumerate(bb["blocks"]):
            old = _old_block(old, p, cfg, windows[i])
            new = vit.run_blocks(t, bb["blocks"][:i + 1], cfg,
                                 windows[:i + 1])
            assert torch.equal(new, old), i
        out = vit.vit_forward(bb, images, cfg)
    assert out.dtype == dtype and torch.equal(out, old)


def test_the_pyramid_is_the_same_as_before(narrow):
    """The simple feature pyramid, P2's LN with its GELU and every
    level's two LNs: the same five levels as before, bit for bit, but for
    P2 in float32. There the GELU now runs on the LN's NHWC rows, where it
    ran on their NCHW view in channels_last memory, and ATen's CPU GELU
    rounds the two layouts differently (up to 7.2e-7 here, the same values
    otherwise): P2 in float32 is held within 1e-5."""
    cfg, state, images, dtype = narrow
    with torch.inference_mode():
        t = vit.vit_forward(state["backbone"], images, cfg)
        new = vit.simple_feature_pyramid(state["fpn"], t, cfg)
        old = _old_pyramid(state["fpn"], t, cfg)
        y = _old_ln2d(vit._deconv(t.permute(0, 3, 1, 2),
                                  state["fpn"]["p2"]["deconv1"]),
                      state["fpn"]["p2"]["norm"], cfg.ln_eps)
        layouts_agree = torch.equal(
            F.gelu(y), F.gelu(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
    assert len(new) == len(old) == 5
    for i, (a, b) in enumerate(zip(new, old)):
        assert a.dtype == dtype and a.shape == b.shape
        assert a.is_contiguous(memory_format=torch.channels_last)
        if i == 0 and not layouts_agree:
            assert dtype == torch.float32
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, b), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_ln_heads_are_the_same_as_before(dtype):
    """The box head's four conv-LN-ReLU layers and the mask head's, on
    pooled maps in channels_last memory, against ``torch.relu`` after the
    channel LN as before, bit for bit."""
    g = torch.Generator().manual_seed(3)
    cfg = replace(vitdet_b(), fpn_channels=16, mask_conv_dim=16)
    C = 16
    params = {}
    for i in range(1, 5):
        params[f"conv{i}"] = {"w": (torch.randn(C, C, 3, 3, generator=g)
                                    / (9 * C) ** 0.5).to(dtype)}
        params[f"norm{i}"] = {k: v.to(dtype) for k, v in
                              zip("wb", _affine(g, C))}
    pooled = torch.randn(6, 7, 7, C, generator=g).to(dtype)
    with torch.inference_mode():
        new = roi_heads._box_convs(params, pooled, replace(
            cfg, box_num_conv=4))
        x = pooled.permute(0, 3, 1, 2)
        for i in range(1, 5):
            y = F.conv2d(x, params[f"conv{i}"]["w"], padding=1)
            x = torch.relu(_old_ln2d(y, params[f"norm{i}"], cfg.ln_eps))
        old = x.permute(0, 2, 3, 1)
    assert torch.equal(new, old)
    assert new.dtype == dtype and (new >= 0).all()
