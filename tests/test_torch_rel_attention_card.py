"""The ViT's attention kernel (K7, ``csrc/rel_attention.cu``) on the card:
against its plain version at the shapes ViTDet-B runs (the 25 windows of
196 tokens of a 1024 px tile, and the global 4096) and at ragged and small
ones, its time against the least time its work needs, and ViTDet-B's bf16
forward at B = 16 with every attention call through the kernel and no N × N
tensor in device memory.

Marked ``card``: skipped where no CUDA device is present. On the card, from
the repository's root (the file imports no JAX, and ``--noconftest`` keeps
the CPU lane's JAX set-up out):

    python -m pytest tests/test_torch_rel_attention_card.py -m card --noconftest -q -s
"""

import json

import pytest
import torch

from roadsurf_tpu_torch.models.config import vitdet_b
from roadsurf_tpu_torch.models.mask_rcnn import forward_prepared, \
    prepare_state
from roadsurf_tpu_torch.ops import attention as att

pytestmark = pytest.mark.card

BF16_PEAK = 989e12              # H100 SXM dense bf16, 700 W
HBM_BYTES_PER_S = 3.35e12
# the design's floor at ViTDet-B's B = 16 shapes: % of the least time a
# call's work needs (its FLOPs on the row path, its bytes on the window
# path)
FLOOR_PCT = {"window": 25.0, "global": 35.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def inputs(B, Hp, Wp, ws, heads, dev, seed, rel_std=0.1):
    """qkv (B, Hp, Wp, 3, heads, 64) of unit normals and the two tables
    of a drawn relative-position table pair, bf16."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    qkv = torch.randn((B, Hp, Wp, 3, heads, 64), generator=g, device=dev
                      ).to(torch.bfloat16)
    rp = torch.randn((2, 2 * ws - 1, 64), generator=g, device=dev) * rel_std
    rel_h, rel_w = att.rel_tables(qkv[:, :, :, 0], rp[0].to(torch.bfloat16),
                                  rp[1].to(torch.bfloat16), ws)
    return qkv, rel_h, rel_w


# (B, Hp, Wp, ws, heads): ViTDet-B's windowed block at 1024 px (70 = 64
# padded to 5 windows of 14) and its global block; a window of exactly 64
# keys that is not the global path; ragged windows and grids; the smallest;
# windows whose widest key step (7 rows of 28, 3 of 60) would not leave its
# tiles room in shared memory
SHAPES = [(16, 70, 70, 14, 12), (16, 64, 64, 64, 12), (2, 16, 24, 8, 3),
          (3, 28, 42, 14, 2), (1, 60, 60, 30, 2), (2, 12, 12, 6, 1),
          (1, 32, 32, 32, 4), (2, 4, 6, 2, 1), (1, 128, 64, 64, 2),
          (2, 56, 84, 28, 2), (1, 120, 60, 60, 1)]


@pytest.mark.parametrize("rel_std", [0.1, 1.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_its_plain_version(shape, rel_std, card):
    """Two bounds. The whole tensor's: 2⁻⁸·|plain| + 2⁻⁸·max|v|, bf16's
    rounding at the scale of v. The row's own, element by element:
    2⁻⁷·(|plain| + Σⱼ pᵢⱼ|vⱼ|) (``chip_smoke._k7_tolerance``): bf16's unit
    roundoff is 2⁻⁸ on each side's output (2⁻⁷·|plain| together) and on
    each probability the kernel rounds before its product with v
    (2⁻⁸·Σ p|v|), and Σ p|v| is the plain version on |v|, itself rounded
    to bf16; the float32 sums' order is far below both."""
    B, Hp, Wp, ws, heads = shape
    qkv, rel_h, rel_w = inputs(B, Hp, Wp, ws, heads, card, seed=sum(shape),
                               rel_std=rel_std)
    with torch.inference_mode():
        got = att.rel_attention(qkv, rel_h, rel_w, ws, 0.125)
        want = att.rel_attention_ref(qkv, rel_h, rel_w, ws, 0.125)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, Hp, Wp, heads * 64)
    err = (got.float() - want.float()).abs()
    tol = 2 ** -8 * want.float().abs() + 2 ** -8 * qkv[:, :, :, 2].float(
        ).abs().max()
    assert torch.isfinite(got.float()).all()
    assert (err <= tol).all(), (err.max().item(), (err - tol).max().item())
    av = qkv.clone()
    av[:, :, :, 2].abs_()
    with torch.inference_mode():
        spv = att.rel_attention_ref(av, rel_h, rel_w, ws, 0.125).float()
    row = 2 ** -7 * (want.float().abs() + spv)
    assert (err <= row).all(), (err.max().item(), (err / row).max().item())


def test_a_call_through_attention_counts_and_launches(card):
    qkv, _, _ = inputs(2, 28, 28, 14, 2, card, seed=5)
    rp = torch.randn((27, 64), device=card).to(torch.bfloat16)
    before, launches = dict(att.counts), att.launches
    paths = dict(att.path_launches)
    with torch.inference_mode():
        out = att.attention(qkv.view(2, 28, 28, -1), rp, rp, 2, 14)
    assert out.shape == (2, 28, 28, 128)
    assert att.counts["fused"] == before["fused"] + 1
    assert att.counts["plain"] == before["plain"]
    assert att.launches == launches + 1
    assert att.path_launches == {"row": paths["row"],
                                 "window": paths["window"] + 1}


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


@pytest.mark.parametrize("shape", SHAPES[:2], ids=["window", "global"])
def test_kernel_time_against_its_bound(shape, card):
    """CUDA-event time of a call at ViTDet-B's B = 16 shapes beside the
    least time of its work (4·N²·64 FLOPs a head and window at 989
    TFLOP/s, or q, k, v, out and the tables once at 3.35 TB/s) and the
    plain version's; printed as a JSON line. The call reaches at least
    the design's floor of that bound (``FLOOR_PCT``)."""
    B, Hp, Wp, ws, heads = shape
    qkv, rel_h, rel_w = inputs(B, Hp, Wp, ws, heads, card, seed=1)
    N, windows = ws * ws, B * (Hp // ws) * (Wp // ws)
    flops = windows * heads * 4 * N * N * 64
    nbytes = windows * heads * (4 * N * 64 + 2 * N * ws) * 2
    bound = max(flops / BF16_PEAK, nbytes / HBM_BYTES_PER_S) * 1e3
    with torch.inference_mode():
        ms = _time_ms(lambda: att.rel_attention(qkv, rel_h, rel_w, ws,
                                                0.125))
        plain = _time_ms(lambda: att.rel_attention_ref(qkv, rel_h, rel_w,
                                                       ws, 0.125), reps=2)
    kind = "window" if ws != Hp else "global"
    print(json.dumps({"k7": kind, "shape": shape, "ms": ms,
                      "bound_ms": bound, "roofline_pct": 100 * bound / ms,
                      "tflops": flops / ms / 1e9, "plain_ms": plain,
                      "card": torch.cuda.get_device_name(card)}))
    assert ms >= bound
    assert 100 * bound / ms >= FLOOR_PCT[kind], (ms, bound)


def test_vitdet_forward_takes_the_kernel_and_no_n_by_n_tensor(card):
    """ViTDet-B at 1024 px, B = 16 tiles of 256 px, bf16, on the family's
    seeded weights: every attention call through the kernel (12 a
    forward: the 4 global blocks on its row path, the 8 windowed ones on
    its window path), and the forward's peak device memory under 6.4 GB,
    what one global block's materialised scores (16 × 12 × 4096² in bf16)
    would take alone."""
    from portbench import modelgen, spec

    cfg = vitdet_b()
    st = spec.cell("vitdet-b-1024.detect-b16").config["settings"]
    fam = spec.family("vitdet_b")
    g = modelgen.generator(7, card)
    state = prepare_state(fam.weights(st, g, card, torch.bfloat16), cfg,
                          card)
    tiles = torch.from_numpy(modelgen.tiles(16, 256, g, card)).to(card)
    scores = 16 * 12 * 4096 ** 2 * 2
    with torch.inference_mode():
        forward_prepared(state, tiles, cfg, True, "bits")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(card)
        base = torch.cuda.memory_allocated(card)
        before, launches = dict(att.counts), att.launches
        paths = dict(att.path_launches)
        # 3 warm-up forwards and 5 timed, 12 attention calls each
        ms = _time_ms(lambda: forward_prepared(state, tiles, cfg, True,
                                               "bits"), reps=5)
        peak = torch.cuda.max_memory_allocated(card)
    assert att.counts["plain"] == before["plain"]
    assert att.counts["fused"] - before["fused"] == 12 * 8
    assert att.launches - launches == 12 * 8
    assert {k: att.path_launches[k] - paths[k] for k in paths} == {
        "row": 4 * 8, "window": 8 * 8}
    print(json.dumps({"vitdet_b16": {"ms": ms, "tiles_per_s": 16e3 / ms,
                                     "peak_bytes": peak,
                                     "state_and_inputs_bytes": base,
                                     "scores_bytes": scores},
                      "card": torch.cuda.get_device_name(card)}))
    assert peak < scores
