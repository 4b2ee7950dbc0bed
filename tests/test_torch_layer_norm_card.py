"""ViTDet's LayerNorm kernel (K8, ``csrc/layer_norm.cu``) on the card: each
mode against its plain version at the shapes ViTDet-B runs (C = 256, 384,
768) and at ragged ones, the residual sum bit for bit, the padded store's
pad exactly zero, the refusals, the time of a call at the ViT's rows
against its byte bound, and a bf16 ViTDet backbone and pyramid at small
size with and without the kernel.

Marked ``card``: skipped where no CUDA device is present. On the card, from
the repository's root (the file imports no JAX, and ``--noconftest`` keeps
the CPU lane's JAX set-up out):

    python -m pytest tests/test_torch_layer_norm_card.py -m card --noconftest -q -s
"""

import json

import pytest
import torch

from roadsurf_tpu_torch.models import vit
from roadsurf_tpu_torch.ops import layer_norm as lnm

pytestmark = pytest.mark.card

EPS = 1e-6
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, 700 W
# the design's floor at the ViT's B = 16 rows: % of the least time a
# call's bytes need
FLOOR_PCT = 70.0
# ReLU's slope is at most 1, exact GELU's 1.13 (at x = √2)
SLOPE = {None: 1.0, "relu": 1.0, "gelu": 1.13}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda:0")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def inputs(shape, residual, dev, seed, constant=False):
    """x about N(0.5, 2), w about 1, b about 0, and the residual: None,
    contiguous ("dense") or a slice of a larger grid ("strided"); bf16.
    ``constant``: every third row of x one value, the residual's 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    B, H, W, C = shape
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5) \
        .to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(C, generator=g, device=dev)) \
        .to(torch.bfloat16)
    b = (0.1 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
    r = None
    if residual == "dense":
        r = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    elif residual == "strided":
        r = torch.randn((B, H + 6, W + 6, C), generator=g, device=dev) \
            .to(torch.bfloat16)[:, :H, :W]
    if constant:
        x.view(-1, C)[::3] = 0.75
        if r is not None:
            r.view(-1, C)[::3] = 0
    return x, w, b, r


def check(x, w, b, r, act, pad_to, s, y):
    """``s`` bit for bit PyTorch's bf16 add; ``y`` within 2⁻⁸·|plain| +
    1e-4 of the plain version in float32 on that sum (the LN before its
    activation, carried through the activation's slope; GELU's output
    rounded once more, 2⁻⁸ of it); the pad's bits zero."""
    want_s = x if r is None else x + r
    if r is not None:
        assert torch.equal(bits(s), bits(want_s))
    args = (want_s.float(), w.float(), b.float(), EPS)
    _, z = lnm.layer_norm_ref(*args, pad_to=pad_to)
    _, want = lnm.layer_norm_ref(*args, act=act, pad_to=pad_to)
    tol = SLOPE[act] * (2.0 ** -8 * z.abs() + 1e-4)
    if act == "gelu":
        tol += 2.0 ** -8 * want.abs()
    assert y.shape == want.shape and y.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all()
    err = (y.float() - want).abs()
    assert (err <= tol).all(), (err / tol).max().item()
    H, W = x.shape[1:3]
    assert not bits(y)[:, H:].any() and not bits(y)[:, :H, W:].any()


# (name, (B, H, W, C), residual, act, pad_to): ViTDet-B's calls at B = 16
# (block 0's norm1 into the 70x70 padded grid, a windowed block's norm1
# with the MLP's output and its norm2 with the padded grid's slice, a
# global block's two, P2's LN with GELU at 384, a pyramid LN at 256, the
# box and mask heads' with ReLU), then ragged row counts and pads at each
# of the three widths, a strided residual with the padded store
SHAPES = [("norm1_first", (16, 64, 64, 768), None, None, (70, 70)),
          ("norm1_window", (16, 64, 64, 768), "dense", None, (70, 70)),
          ("norm2_window", (16, 64, 64, 768), "strided", None, None),
          ("norm_global", (16, 64, 64, 768), "dense", None, None),
          ("p2_gelu", (16, 128, 128, 384), None, "gelu", None),
          ("pyramid", (16, 128, 128, 256), None, None, None),
          ("box_relu", (16000, 7, 7, 256), None, "relu", None),
          ("mask_relu", (1600, 14, 14, 256), None, "relu", None),
          ("ragged", (1, 3, 5, 768), "dense", None, None),
          ("ragged_relu", (3, 7, 11, 256), "strided", "relu", None),
          ("ragged_pad_gelu", (2, 5, 9, 384), "dense", "gelu", (7, 14)),
          ("strided_padded", (2, 64, 64, 768), "strided", None, (70, 70))]


@pytest.mark.parametrize("name,shape,residual,act,pad_to", SHAPES,
                         ids=[c[0] for c in SHAPES])
def test_kernel_matches_its_plain_version(name, shape, residual, act,
                                          pad_to, card):
    x, w, b, r = inputs(shape, residual, card, len(name) + sum(shape))
    launches = lnm.launches
    s, y = lnm.layer_norm_rows(x, w, b, EPS, r, act, pad_to)
    torch.cuda.synchronize(card)
    assert lnm.launches == launches + 1
    assert (s is x) == (r is None)
    check(x, w, b, r, act, pad_to, s, y)


@pytest.mark.parametrize("residual", [None, "dense"])
def test_a_row_of_one_value_gives_the_bias(residual, card):
    """Variance 0: the row's output is ``b`` (then the activation), as
    ATen's."""
    x, w, b, r = inputs((2, 8, 8, 768), residual, card, 5, constant=True)
    s, y = lnm.layer_norm_rows(x, w, b, EPS, r, None, (9, 9))
    torch.cuda.synchronize(card)
    check(x, w, b, r, None, (9, 9), s, y)
    rows = y[:, :8, :8].reshape(-1, 768)[::3]
    assert torch.equal(bits(rows), bits(b.expand_as(rows)))


def test_the_dispatch_counts_and_launches(card):
    """``layer_norm`` on bf16 rows on the card in inference takes the
    kernel; with grad on, the plain version."""
    x, w, b, r = inputs((2, 5, 5, 256), "dense", card, 3)
    before, launches = dict(lnm.counts), lnm.launches
    with torch.inference_mode():
        s, y = lnm.layer_norm(x, w, b, EPS, residual=r, act="relu")
    with torch.enable_grad():
        ps, py = lnm.layer_norm(x, w, b, EPS, residual=r, act="relu")
    assert lnm.counts["fused"] == before["fused"] + 1
    assert lnm.counts["plain"] == before["plain"] + 1
    assert lnm.launches == launches + 1
    assert torch.equal(bits(s), bits(ps))
    check(x, w, b, r, "relu", None, s, y)


def test_a_layout_the_kernel_does_not_take_raises(card):
    """On the card in inference every LN at a width the kernel takes
    engages: rows that are not (B, H, W, C) with C contiguous and aligned
    raise, and do not give way to the plain version."""
    w = torch.ones(256, device=card, dtype=torch.bfloat16)
    nchw = torch.zeros((2, 256, 4, 4), device=card, dtype=torch.bfloat16)
    plain = lnm.counts["plain"]
    with torch.inference_mode():
        with pytest.raises(ValueError, match="16-byte aligned"):
            vit.ln2d(nchw, {"w": w, "b": w}, EPS)
        flat = torch.zeros(2 * 4 * 4 * 256 + 1, device=card,
                           dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte aligned"):
            lnm.layer_norm(flat[1:].view(2, 4, 4, 256), w, w, EPS)
    assert lnm.counts["plain"] == plain


def _time_ms(fn, reps=20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.parametrize("name,shape,residual,act,pad_to", SHAPES[:4],
                         ids=[c[0] for c in SHAPES[:4]])
def test_kernel_time_against_its_bound(name, shape, residual, act, pad_to,
                                       card):
    """A call at the ViT's rows (B = 16, 4096 × 768) against the least
    time its bytes need: x, w, b, and with a residual r and s, read or
    written once, y at the padded grid."""
    x, w, b, r = inputs(shape, residual, card, 9)
    B, H, W, C = shape
    Hp, Wp = pad_to or (H, W)
    nbytes = B * H * W * C * 2 * (1 if r is None else 3) \
        + B * Hp * Wp * C * 2 + 4 * C
    ms = _time_ms(lambda: lnm.layer_norm_rows(x, w, b, EPS, r, act, pad_to))
    plain_ms = _time_ms(lambda: lnm.layer_norm_ref(x, w, b, EPS, r, act,
                                                   pad_to), reps=5)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pct = 100 * bound_ms / ms
    print(json.dumps({"case": name, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "pct_of_bound": pct,
                      "card": torch.cuda.get_device_name(card)}))
    assert pct >= FLOOR_PCT


def test_small_vitdet_forward_with_and_without_the_kernel(card):
    """A bf16 ViTDet backbone and pyramid on the card at ViTDet-B's widths
    (768, 12 heads of 64, a 256-channel pyramid) but small: the family's
    narrow depth of 6 at 128 px, windows of 6 padded to 12. Every LN
    through the kernel, against the same forward with the kernel stood
    down (every LN through the plain version): the backbone's tokens and
    the pyramid's levels agree within the bf16 rounding the two LNs'
    orders leave (1% of each tensor's norm), in the same layouts."""
    from portbench import harness, modelgen, spec
    from roadsurf_tpu_torch.models.mask_rcnn import prepare_state

    cell = spec.cell("vitdet-b-1024.detect-b16")
    st = dict(cell.config["settings"], min_size_test=128, vit_depth=6,
              vit_window=6, vit_global_blocks=[2, 5])
    cfg = harness.port_config(cell.config, st)
    state = prepare_state(cell.family.weights(
        st, modelgen.generator(2 ** 31 + 27, card), card, torch.bfloat16),
        cfg, card)
    side = st["min_size_test"]
    images = torch.randn((4, 3, side, side), device=card,
                         generator=torch.Generator(device=card)
                         .manual_seed(27)).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)

    def run():
        with torch.inference_mode():
            t = vit.vit_forward(state["backbone"], images, cfg)
            return [t, *vit.simple_feature_pyramid(state["fpn"], t, cfg)]

    before, launches = dict(lnm.counts), lnm.launches
    fused = run()
    n = lnm.counts["fused"] - before["fused"]
    assert n == 2 * st["vit_depth"] + 9
    assert lnm.launches - launches == n
    assert lnm.counts["plain"] == before["plain"]
    kernel = lnm.layer_norm_rows
    lnm.layer_norm_rows = lnm.layer_norm_ref
    try:
        plain = run()
    finally:
        lnm.layer_norm_rows = kernel
    for a, p in zip(fused, plain):
        assert a.shape == p.shape and a.stride() == p.stride()
        rel = ((a.float() - p.float()).norm() / p.float().norm()).item()
        assert rel < 1e-2, rel
