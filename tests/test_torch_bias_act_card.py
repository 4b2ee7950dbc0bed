"""The conv epilogue kernel (``csrc/bias_act.cu``) on the card, against the
PyTorch ops it replaces, bit for bit (the bf16 bits compared, NaN and ±0
included), and the bf16 forwards with and without it.

Marked ``card``: skipped where no CUDA device is present. On the card, from
the repository's root (the file imports no JAX, and ``--noconftest`` keeps
the CPU lane's JAX set-up out):

    python -m pytest tests/test_torch_bias_act_card.py -m card --noconftest -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from roadsurf_tpu_torch.models import ModelConfig, fast_profile, init_params
from roadsurf_tpu_torch.models.mask_rcnn import forward_prepared
from roadsurf_tpu_torch.ops import bias_act as epilogue
from roadsurf_tpu_torch.utils.weights import from_jax_params, state_to

pytestmark = pytest.mark.card

CL = torch.channels_last
SPECIAL = (float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1e-40)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda:0")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def special(g, shape, dev) -> torch.Tensor:
    """Normal bf16 values in channels_last memory (4-d), with NaN, ±0,
    ±inf and a subnormal at seeded places."""
    t = torch.randn(shape, generator=g, device=dev)
    flat = t.view(-1)
    n = 8 * len(SPECIAL)
    idx = torch.randint(0, flat.numel(), (n,), generator=g, device=dev)
    flat[idx] = torch.tensor(SPECIAL, device=dev).repeat(8)
    t = t.to(torch.bfloat16)
    return t.contiguous(memory_format=CL) if t.dim() == 4 else t


# (kind, (N, C, H, W)): C = 3, 12, 64, 256, 2048; odd sides; the first and
# last stages of both configurations (800 px parity: stem 400², res2 200²,
# res5 25², P6 13², the mask head's 14² and 28² maps of 16 × 100
# detections; 256 px fast: stem 128², res2 64², res5 8²) at B = 1 and at
# the cells' B (16 parity, 512 fast)
CASES = [
    ("bias", (2, 3, 13, 11)),
    ("bias", (16, 3, 200, 200)),
    ("bias", (2, 12, 13, 11)),
    ("bias", (512, 12, 64, 64)),
    ("bias", (16, 256, 13, 13)),
    ("bias_relu", (3, 64, 7, 9)),
    ("bias_relu", (1, 64, 400, 400)),
    ("bias_relu", (16, 64, 400, 400)),
    ("bias_relu", (512, 64, 128, 128)),
    ("bias_relu", (1600, 256, 14, 14)),
    ("bias_relu", (1600, 256, 28, 28)),
    ("tail_identity", (1, 256, 200, 200)),
    ("tail_identity", (16, 256, 200, 200)),
    ("tail_identity", (512, 256, 64, 64)),
    ("tail_identity", (16, 2048, 25, 25)),
    ("tail_shortcut", (3, 256, 25, 25)),
    ("tail_shortcut", (1, 2048, 25, 25)),
    ("tail_shortcut", (16, 2048, 25, 25)),
    ("tail_shortcut", (512, 2048, 8, 8)),
    ("tail_shortcut", (2, 12, 5, 3)),
    ("lateral", (2, 64, 6, 10)),
    ("lateral", (1, 256, 200, 200)),
    ("lateral", (16, 256, 200, 200)),
    ("lateral", (16, 256, 50, 50)),
    ("lateral", (512, 256, 64, 64)),
    ("lateral", (2, 12, 4, 2)),
]


def _id(case):
    kind, shape = case
    return f"{kind}-{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("kind,shape", CASES, ids=[_id(c) for c in CASES])
def test_the_kernel_is_the_ops_it_replaces(card, kind, shape):
    """The epilogue against ATen's sequence: the conv's in-place broadcast
    bias add, then ``relu_``, the residual sum (the shortcut conv's output
    with its own bias added first) or the top-down sum with the coarser
    level upsampled."""
    g = torch.Generator(device=card).manual_seed(sum(shape) * 7 + len(kind))
    N, C, H, W = shape
    y = special(g, shape, card)
    b = special(g, (C,), card)
    want = y.clone().add_(b.view(1, -1, 1, 1))
    kw = {}
    if kind == "bias_relu":
        kw = {"relu": True}
        want = torch.relu_(want)
    elif kind == "tail_identity":
        r = special(g, shape, card)
        kw = {"relu": True, "residual": r}
        want = torch.relu_(want + r)
    elif kind == "tail_shortcut":
        r, rb = special(g, shape, card), special(g, (C,), card)
        kw = {"relu": True, "residual": r, "residual_bias": rb}
        want = torch.relu_(want + r.clone().add_(rb.view(1, -1, 1, 1)))
    elif kind == "lateral":
        t = special(g, (N, C, H // 2, W // 2), card)
        kw = {"coarser": t}
        want = want + t.repeat_interleave(2, dim=2) \
            .repeat_interleave(2, dim=3)
    launches = epilogue.launches
    got = y.clone()
    out = epilogue.bias_act(got, b, **kw)
    torch.cuda.synchronize(card)
    assert out is got
    assert epilogue.launches == launches + 1
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(epilogue.bias_act_ref(y, b, **kw)), bits(want))


# (input (N, C, H, W), output channels, kernel side, stride, relu)
CONVS = [((2, 3, 800, 800), 64, 7, 2, True),
         ((16, 64, 200, 200), 256, 1, 1, False),
         ((16, 256, 200, 200), 256, 3, 1, True),
         ((512, 1024, 16, 16), 2048, 1, 2, False),
         ((16, 256, 200, 200), 3, 1, 1, False)]


@pytest.mark.parametrize("shape,cout,k,stride,relu", CONVS)
def test_a_conv_without_its_bias_then_the_kernel_is_the_conv_with_it(
        card, shape, cout, k, stride, relu):
    """cuDNN's conv without the bias, then the epilogue, equals
    ``F.conv2d`` with the bias (and ``relu_``) bit for bit: PyTorch adds a
    cuDNN conv's bias after the conv, as the kernel does."""
    g = torch.Generator(device=card).manual_seed(k * 1000 + cout)
    x = (torch.randn(shape, generator=g, device=card)
         .to(torch.bfloat16).contiguous(memory_format=CL))
    w = (torch.randn((cout, shape[1], k, k), generator=g, device=card)
         / (shape[1] * k * k) ** 0.5).to(torch.bfloat16) \
        .contiguous(memory_format=CL)
    b = torch.randn(cout, generator=g, device=card).to(torch.bfloat16)
    with torch.inference_mode():
        want = F.conv2d(x, w, b, stride=stride, padding=k // 2)
        want = torch.relu_(want) if relu else want
        got = epilogue.bias_act(F.conv2d(x, w, stride=stride,
                                         padding=k // 2), b, relu=relu)
    assert torch.equal(bits(got), bits(want))


def test_a_conv_whose_output_the_kernel_cannot_take_raises(card):
    """On the card in inference every bf16 conv of the forward takes the
    kernel, whatever its layout: a conv whose output is not in
    channels_last memory (NCHW input and weight) raises, and does not give
    way to the plain ops."""
    from roadsurf_tpu_torch.models.resnet import conv

    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((2, 8, 9, 7), generator=g, device=card) \
        .to(torch.bfloat16)
    p = {"w": torch.randn((16, 8, 3, 3), generator=g, device=card)
         .to(torch.bfloat16),
         "b": torch.randn(16, generator=g, device=card).to(torch.bfloat16)}
    plain = epilogue.counts["plain"]
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="channels_last"):
        conv(x, p, relu=True)
    assert epilogue.counts["plain"] == plain


def _state(cfg, device):
    """Random weights at the configuration's widths: the residual
    branches' FrozenBN scales and every conv's bias non-zero."""
    gen = torch.Generator().manual_seed(0)
    tree = init_params(cfg, gen)
    for stage in ("res2", "res3", "res4", "res5"):
        for bp in tree["backbone"][stage]:
            sc = bp["conv3"]["scale"]
            bp["conv3"]["scale"] = 0.1 + 0.2 * torch.rand(sc.shape,
                                                           generator=gen)
    state = from_jax_params(tree)

    def biases(node):
        if isinstance(node, dict):
            if "w" in node and "b" in node and node["w"].dim() == 4:
                node["b"] = 0.1 * torch.randn(node["b"].shape, generator=gen)
            for v in node.values():
                biases(v)
        elif isinstance(node, list):
            for v in node:
                biases(v)

    biases(state)
    return state_to(state, device, torch.bfloat16)


@pytest.mark.parametrize("profile", ["parity", "fast"])
def test_the_bf16_forward_is_the_same_with_and_without_the_kernel(
        card, profile):
    """The whole bf16 forward at full width in inference (the epilogue in
    every conv) and with grad on (the plain ops): detections, scores,
    classes and mask logits bit for bit."""
    cfg = ModelConfig() if profile == "parity" \
        else fast_profile(post_nms_topk=32)
    state = _state(cfg, card)
    images = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 256, 256, 3), dtype=np.uint8)).to(card)
    before = dict(epilogue.counts)
    with torch.inference_mode():
        fused = forward_prepared(state, images, cfg, True, "logits")
    mid = dict(epilogue.counts)
    with torch.enable_grad():
        plain = forward_prepared(state, images, cfg, True, "logits")
    after = dict(epilogue.counts)
    torch.cuda.synchronize(card)
    assert mid["fused"] > before["fused"] and mid["plain"] == before["plain"]
    assert after["plain"] - mid["plain"] == mid["fused"] - before["fused"]
    assert after["fused"] == mid["fused"]
    assert set(fused) == set(plain)
    assert int(fused["valid"].sum()) > 0
    for key in fused:
        a, b = fused[key], plain[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        same = torch.equal(bits(a), bits(b)) if a.is_floating_point() \
            else torch.equal(a, b)
        assert same, key
