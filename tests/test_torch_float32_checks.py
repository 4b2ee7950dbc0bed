"""The float32 modes of the poolers' kernels (K1, K2: float32 levels and
output) and of their gradient (K5: a float32 d pooled), as far as the CPU
can see them: the wrappers' checks accept float32 CPU tensors and refuse
the layouts they refused before; the ctypes signatures match the C entry
points' parameter lists (a mismatch would show only on the card); a
block's shared memory fits at every P in float32; and on CPU tensors the
wrappers run their plain versions in float32 without counting a launch.

The kernels themselves run only on the card: ``chip_smoke.py`` holds them
against their plain versions there at <= 1e-5·max|plain| + 1e-6.
"""

from __future__ import annotations

import re

import pytest
import torch

from roadsurf_tpu_torch.ops import cuda_build
from roadsurf_tpu_torch.ops import roi_align as tra
from roadsurf_tpu_torch.ops import roi_align_backward_kernel as k5
from roadsurf_tpu_torch.ops import roi_align_blocked_kernel as k2
from roadsurf_tpu_torch.ops import roi_align_kernel as k1

torch.set_num_threads(1)

B, R, C = 2, 4, 16


def _levels(sides, dtype=torch.float32, C=C):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn((B, s, s, C), generator=g).to(dtype)
                 for s in sides)


def _boxes():
    boxes = torch.tensor([[[0.0, 0.0, 40.0, 30.0], [8.0, 4.0, 9.0, 60.0],
                           [3.0, 3.0, 50.0, 50.0], [0.0, 0.0, 0.0, 0.0]]])
    return boxes.expand(B, R, 4).contiguous()


def _lvl(feats, boxes):
    return tra.level_assignment(boxes, 224, 4, 2, 2 + tra.reachable_levels(
        feats) - 1).contiguous()


@pytest.mark.parametrize("mod,sampling", [(k1, 2), (k2, 0), (k2, 2)])
def test_pooler_checks_take_float32_levels(mod, sampling):
    feats = _levels((64, 32, 16))
    boxes = _boxes()
    mod._check(feats, boxes, _lvl(feats, boxes), 7, sampling)
    mod._check(feats, boxes, _lvl(feats, boxes), 14, sampling)


@pytest.mark.parametrize("mod,sampling", [(k1, 2), (k2, 0)])
def test_pooler_checks_refuse_what_they_refused_before(mod, sampling):
    """Other float types, levels of two types, C off the 8-channel lanes,
    P beyond 32, a level 4 bytes off 16-byte alignment, a transposed
    level: refused for float32 levels as for bf16 ones."""
    feats = _levels((64, 32, 16))
    boxes = _boxes()
    lvl = _lvl(feats, boxes)
    with pytest.raises(TypeError):
        mod._check(tuple(f.double() for f in feats), boxes, lvl, 7,
                   sampling)
    with pytest.raises(TypeError):
        mod._check((feats[0].bfloat16(),) + feats[1:], boxes, lvl, 7,
                   sampling)
    with pytest.raises(TypeError):
        mod._check(feats, boxes, lvl, 7, sampling,
                   torch.ones(3, dtype=torch.float32))
    with pytest.raises(ValueError, match="multiple of 8"):
        mod._check(_levels((64, 32, 16), C=12), boxes, lvl, 7, sampling)
    with pytest.raises(ValueError):
        mod._check(feats, boxes, lvl, 33, sampling)
    base = torch.zeros(B * 64 * 64 * C + 1)
    off = base[1:].view(B, 64, 64, C)          # 4 bytes past the storage
    with pytest.raises(ValueError, match="16-byte"):
        mod._check((off,) + feats[1:], boxes, lvl, 7, sampling)
    with pytest.raises(ValueError):
        mod._check((feats[0].transpose(1, 2),) + feats[1:], boxes, lvl, 7,
                   sampling)


def _k5_args(dout_dtype, out_dtype, P=7, C=256):
    shapes = [(B, s, s, C) for s in (64, 32, 16)]
    dout = torch.zeros((B, R, P, P, C), dtype=dout_dtype)
    boxes = _boxes()
    lvl = _lvl([torch.empty(s, device="meta") for s in shapes], boxes)
    return dout, shapes, boxes, lvl, P, 2, out_dtype


def test_k5_check_takes_a_float32_dout_for_float32_gradients():
    k5._check(*_k5_args(torch.float32, torch.float32))
    k5._check(*_k5_args(torch.float32, torch.float32, P=14))
    k5._check(*_k5_args(torch.bfloat16, torch.float32))
    k5._check(*_k5_args(torch.bfloat16, torch.bfloat16))


def test_k5_check_refuses_what_it_refused_before():
    """A float32 d pooled only gives float32 gradients; float64, C off
    the lanes and P beyond 32 stay refused."""
    with pytest.raises(ValueError, match="float32 dout"):
        k5._check(*_k5_args(torch.float32, torch.bfloat16))
    with pytest.raises(ValueError):
        k5._check(*_k5_args(torch.float64, torch.float32))
    with pytest.raises(ValueError):
        k5._check(*_k5_args(torch.float32, torch.float32, C=12))
    with pytest.raises(ValueError):
        k5._check(*_k5_args(torch.float32, torch.float32, P=33))
    with pytest.raises(TypeError):
        k5._check(*_k5_args(torch.bfloat16, torch.float64))


def test_k5_fits_a_block_in_float32():
    """The ring's slots take a float32 slice in whole bin rows (more parts
    a box than bf16's), and two blocks still fit an SM at P 7 and 14."""
    for P in range(1, k1.KERNEL["kMaxOut"] + 1):
        assert k5.smem_bytes(P, 4) <= k1.KERNEL["kMaxSmem"]
        assert k5.part_bins(P, 4) * P * k5.chunk_c(P) * 4 <= \
            k5.KERNEL["kMaxSlotBytes"]
        assert k5.part_bins(P, 4) * P <= k5.KERNEL["kMaxCopyRows"]
    for P in (7, 14):
        assert 2 * k5.smem_bytes(P, 4) <= k1.KERNEL["kMaxSmem"]
        assert k5.part_bins(P, 4) < P == k5.part_bins(P, 2)


def _c_params(source: str, fn: str) -> int:
    """The number of parameters of ``fn`` in ``csrc/<source>``."""
    text = (cuda_build.CSRC / source).read_text()
    m = re.search(rf"\bint {fn}\(([^)]*)\)", text)
    return len(m.group(1).split(","))


def test_the_ctypes_signatures_match_the_c_entry_points():
    assert _c_params("roi_align.cu", "roi_align_run") \
        == len(k1.POOLER_ARGTYPES)
    assert _c_params("roi_align_blocked.cu", "roi_align_blocked_run") \
        == len(k1.POOLER_ARGTYPES)
    # out, out_f32, dout_f32, 4 sides of 2, n_levels, min_level, boxes,
    # lvl, dout, B, R, C, P, sampling, device, stream
    assert _c_params("roi_align_backward.cu", "roi_align_backward_run") \
        == 1 + 2 + 2 * k1.MAX_LEVELS + 2 + 3 + 5 + 2


def test_cpu_tensors_take_the_plain_versions_in_float32():
    """The wrappers on CPU tensors: float32 out equal to the plain
    version's, no launch counted; the gradient through RoIAlignFunction
    is the plain gradient, in float32."""
    feats = _levels((64, 32, 16))
    boxes = _boxes()
    lvl = _lvl(feats, boxes)
    before = (k1.roi_align_fused.launches_f32,
              k2.roi_align_fused_blocked.launches_f32,
              k5.roi_align_backward.launches_f32)
    for wrapper, ref, s in ((k1.roi_align_fused, k1.roi_align_fused_ref, 2),
                            (k2.roi_align_fused_blocked,
                             k2.roi_align_fused_blocked_ref, 0)):
        out = wrapper(feats, boxes, lvl, 7, s)
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, ref(feats, boxes, lvl, 7, s),
                                   rtol=0, atol=0)
    xs = [f.clone().requires_grad_() for f in feats]
    out = tra.roi_align_multilevel(xs, boxes, 7, sampling=0)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    out.backward(dout)
    want = k5.roi_align_backward_ref(dout, [f.shape for f in feats], boxes,
                                     lvl, 7, 0)
    for x, w in zip(xs, want):
        assert x.grad.dtype == torch.float32
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)
    assert (k1.roi_align_fused.launches_f32,
            k2.roi_align_fused_blocked.launches_f32,
            k5.roi_align_backward.launches_f32) == before


def test_the_card_forwards_logit_scale_is_the_cpu_tests():
    """``chip_smoke.py``'s float32 forwards hold mask logits within
    1e-4·max(1, max|logit| / MASK_LOGIT_SCALE): the 1e-4 that the CPU
    parity test (``tests/test_torch_port_model.py``, the narrow tree at 64
    px) sets at its logits' magnitude. That magnitude is the scale, within
    1%."""
    import numpy as np

    import chip_smoke
    from roadsurf_tpu_torch.models import forward_inference
    from roadsurf_tpu_torch.utils.weights import from_jax_params
    from test_torch_port_model import narrow_cfg, narrow_tree

    cfg = narrow_cfg(64)
    imgs = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 3),
                                             np.uint8)
    out = forward_inference(from_jax_params(narrow_tree(cfg)), imgs, cfg,
                            device="cpu")
    top = float(out["mask_logits"][out["valid"]].abs().max())
    assert abs(top / chip_smoke.MASK_LOGIT_SCALE - 1.0) < 0.01, top
    assert chip_smoke.MASK_ABS == 1e-4
