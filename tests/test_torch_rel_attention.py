"""The ViT's attention (``ops/attention.py``) on the CPU: its plain version
against detectron2's materialised form (``portbench/vitdet_reference.py``,
a transcription of ``modeling/backbone/vit.py`` and ``utils.py``) in
windows, padded windows and over the whole grid, the relative-position
terms from the unscaled ``q``, the counters, the kernel wrapper's
refusals, and the kernel's name as the benchmark reads it. The kernel
itself runs only on the card (``tests/test_torch_rel_attention_card.py``).
"""

import re
from dataclasses import replace

import pytest
import torch
import torch.nn.functional as F

from portbench import trace
from portbench import vitdet_reference as V
from roadsurf_tpu_torch.models import vit
from roadsurf_tpu_torch.models.config import vitdet_b
from roadsurf_tpu_torch.ops import attention as att
from roadsurf_tpu_torch.ops import cuda_build, launch_counts, \
    reset_launch_counts

torch.set_num_threads(1)

# float32 on the CPU: the same products in another order
TOL = 1e-5


def _params(g, dim, heads, side, rel_std=0.5):
    """One block's attention weights, float32, with the output projection
    the identity (so detectron2's ``Attention`` returns the attention)."""
    hd = dim // heads
    return {"qkv": {"w": torch.randn(3 * dim, dim, generator=g) / dim ** 0.5,
                    "b": torch.randn(3 * dim, generator=g) * 0.1},
            "proj": {"w": torch.eye(dim), "b": torch.zeros(dim)},
            "rel_pos_h": torch.randn(2 * side - 1, hd, generator=g)
            * rel_std,
            "rel_pos_w": torch.randn(2 * side - 1, hd, generator=g)
            * rel_std}


def _program(x, p, heads, side):
    qkv = F.linear(x, p["qkv"]["w"], p["qkv"]["b"])
    return att.attention(qkv, p["rel_pos_h"], p["rel_pos_w"], heads, side)


# (B, Hp, Wp, ws, dim, heads): windows of 3 on a 9x9 grid, of 4 on 8x12,
# of 2; the whole grid as one window (the global attention)
CASES = [(2, 9, 9, 3, 32, 2), (1, 8, 12, 4, 24, 3), (3, 4, 4, 2, 16, 1),
         (2, 8, 8, 8, 32, 2), (1, 6, 6, 6, 64, 1)]


@pytest.mark.parametrize("case", CASES)
def test_plain_attention_is_detectron2s(case):
    """``attention`` on a grid against detectron2's ``Attention`` on each
    window of ``window_partition`` (the grid itself where the window is
    the grid), unpartitioned."""
    B, Hp, Wp, ws, dim, heads = case
    g = torch.Generator().manual_seed(sum(case))
    p = _params(g, dim, heads, ws)
    x = torch.randn(B, Hp, Wp, dim, generator=g)
    windows, pad_hw = V.window_partition(x, ws)
    want = V.window_unpartition(V.attention(p, windows, heads), ws, pad_hw,
                                (Hp, Wp))
    got = _program(x, p, heads, ws)
    assert got.shape == (B, Hp, Wp, dim)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def test_the_relative_terms_use_the_unscaled_q():
    """``rel_tables`` is ``add_decomposed_rel_pos``' einsums of ``q``, not
    of ``q · scale``; and the terms change the result."""
    g = torch.Generator().manual_seed(3)
    B, H, W, ws, heads, hd = 2, 6, 6, 3, 2, 16
    q = torch.randn(B, H, W, heads, hd, generator=g)
    rph, rpw = (torch.randn(2 * ws - 1, hd, generator=g) for _ in range(2))
    rel_h, rel_w = att.rel_tables(q, rph, rpw, ws)
    Rh = V.get_rel_pos(ws, ws, rph)
    Rw = V.get_rel_pos(ws, ws, rpw)
    qw = q.reshape(B, H // ws, ws, W // ws, ws, heads, hd)
    want_h = torch.einsum("byixjhc,ikc->byixjhk", qw, Rh)
    want_w = torch.einsum("byixjhc,jkc->byixjhk", qw, Rw)
    torch.testing.assert_close(rel_h, want_h.reshape(B, H, W, heads, ws),
                               atol=TOL, rtol=0)
    torch.testing.assert_close(rel_w, want_w.reshape(B, H, W, heads, ws),
                               atol=TOL, rtol=0)
    p = _params(g, heads * hd, heads, ws)
    x = torch.randn(B, H, W, heads * hd, generator=g)
    flat = dict(p, rel_pos_h=torch.zeros_like(rph),
                rel_pos_w=torch.zeros_like(rpw))
    assert (_program(x, p, heads, ws) - _program(x, flat, heads, ws)
            ).abs().max() > 0.01


@pytest.mark.parametrize("window", [3, 0], ids=["padded-windows", "global"])
def test_a_block_is_detectron2s(window):
    """A whole block on an 8x8 grid: windows of 3 pad it to 9x9 after
    ``norm1`` (the padded tokens are keys), or the global attention."""
    g = torch.Generator().manual_seed(11 + window)
    dim, heads, side = 32, 2, window or 8
    p = _params(g, dim, heads, side)
    p["proj"] = {"w": torch.randn(dim, dim, generator=g) / dim ** 0.5,
                 "b": torch.randn(dim, generator=g) * 0.1}
    for name in ("norm1", "norm2"):
        p[name] = {"w": 1 + 0.1 * torch.randn(dim, generator=g),
                   "b": 0.1 * torch.randn(dim, generator=g)}
    p["fc1"] = {"w": torch.randn(4 * dim, dim, generator=g) / dim ** 0.5,
                "b": torch.zeros(4 * dim)}
    p["fc2"] = {"w": torch.randn(dim, 4 * dim, generator=g) / 8,
                "b": torch.zeros(dim)}
    cfg = replace(vitdet_b(), vit_dim=dim, vit_heads=heads,
                  vit_window=3, compute_dtype="float32")
    st = {"ln_eps": cfg.ln_eps, "vit_heads": heads}
    x = torch.randn(2, 8, 8, dim, generator=g)
    torch.testing.assert_close(vit.run_blocks(x, [p], cfg, [window]),
                               V.block(p, x, st, window), atol=TOL, rtol=0)


def test_the_cpu_and_training_take_the_plain_version():
    qkv = torch.zeros(1, 4, 4, 3 * 64)
    rp = torch.zeros(7, 64)
    before = dict(att.counts)
    att.attention(qkv, rp, rp, 1, 4)
    with torch.enable_grad():
        att.attention(qkv.bfloat16().requires_grad_(), rp, rp, 1, 4)
    assert att.counts["plain"] == before["plain"] + 2
    assert att.counts["fused"] == before["fused"]
    assert not att.engages(qkv)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _good(B=2, Hp=28, Wp=28, heads=2, ws=14):
    return (_meta((B, Hp, Wp, 3, heads, 64)), _meta((B, Hp, Wp, heads, ws)),
            _meta((B, Hp, Wp, heads, ws)), ws)


def test_the_wrapper_takes_what_the_kernel_takes():
    att._check(*_good())
    att._check(*_good(Hp=64, Wp=64, ws=64))


def _offset(shape, elems):
    """A contiguous bf16 meta tensor of ``shape`` starting ``elems``
    values into its storage (its address ``2 · elems`` bytes past an
    aligned one)."""
    n = 1
    for d in shape:
        n *= d
    return _meta((n + elems,))[elems:].view(shape)


@pytest.mark.parametrize("bad, err", [
    (lambda a: (a[0].float(), *a[1:]), TypeError),
    (lambda a: (_meta((2, 28, 28, 3, 2, 32)), *a[1:]), ValueError),
    (lambda a: (a[0].transpose(1, 2), *a[1:]), ValueError),
    (lambda a: (a[0], a[1][..., :7], *a[2:]), ValueError),
    (lambda a: _good(Hp=21, Wp=21, ws=7), ValueError),
    (lambda a: _good(Hp=30, Wp=28), ValueError),
    (lambda a: _good(Hp=66, Wp=66, ws=66), ValueError),
    (lambda a: _good(B=2700, Hp=10, Wp=10, ws=2), ValueError),
    (lambda a: (_offset(a[0].shape, 4), *a[1:]), ValueError),
    (lambda a: (a[0], _offset(a[1].shape, 1), *a[2:]), ValueError),
], ids=["float32", "head-dim-32", "strided", "table", "odd-window",
        "untiled-grid", "window-66", "too-many-windows", "qkv-8-bytes-off",
        "table-2-bytes-off"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        att._check(*bad(_good()))


def test_the_kernel_runs_on_the_card_only():
    qkv = torch.zeros(1, 4, 4, 3, 1, 64, dtype=torch.bfloat16)
    tab = torch.zeros(1, 4, 4, 1, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        att.rel_attention(qkv, tab, tab, 4, 0.125)
    with pytest.raises(ValueError, match="relative-position"):
        att.rel_tables(qkv[:, :, :, 0].float(), torch.zeros(5, 64),
                       torch.zeros(7, 64), 4)


def test_launches_count_with_the_other_kernels():
    assert "rel_attention" in cuda_build.SOURCES
    assert launch_counts()["rel_attention"] == att.launches
    att.launches = 5
    reset_launch_counts()
    assert att.launches == 0 and launch_counts()["rel_attention"] == 0


def test_path_launches_reset_with_the_launch_counts():
    """``path_launches`` counts the kernel's launches by tiling, the row
    path where a window is 64 wide and the window path below, and
    ``ops.reset_launch_counts`` sets both back to 0."""
    assert set(att.path_launches) == {"row", "window"}
    assert att.path(64) == "row"
    assert [att.path(ws) for ws in (2, 14, 32, 62)] == ["window"] * 4
    att.path_launches.update(row=4, window=8)
    reset_launch_counts()
    assert att.path_launches == {"row": 0, "window": 0}


def test_the_benchmark_finds_the_kernel_by_its_name():
    """Each kernel's name holds ``rel_attention``, which the roofline's
    reader looks for, and no key of the trace's categories: it reads
    "other", not "gemm" or "elementwise". The one kernel template is
    launched as the row path (its keys a step, ``true``) and the window
    path (its key slots a step, ``false``)."""
    src = (cuda_build.CSRC / "rel_attention.cu").read_text()
    names = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                           r"(\w+)\(", src))
    assert names == {"rel_attention_fwd_kernel"}
    keys = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kRowKeys", "kWinKeys")}
    assert "launch<kRowKeys, true>" in src
    assert "launch<kWinKeys, false>" in src
    for kn, flag in ((keys["kRowKeys"], "true"),
                     (keys["kWinKeys"], "false")):
        name = (f"void (anonymous namespace)::rel_attention_fwd_kernel<"
                f"{kn}, {flag}>(CUtensorMap_st, CUtensorMap_st, "
                f"(anonymous namespace)::Params)")
        assert "rel_attention" in name
        assert trace.category(name) == "other"
