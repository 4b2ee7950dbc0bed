"""The int8 modes of the PyTorch port's poolers (K1 ``roi_align_fused``,
K2 ``roi_align_fused_blocked``): their plain versions against the JAX
package, on the CPU.

Tolerances: the plain versions equal JAX's separable path on the
dequantized levels to atol 1e-5 (the same float32 products summed in
another order); JAX's XLA path with ``feat_scales`` rounds its weights and
its row sums to bf16 (rtol 2⁻⁶, atol 2e-2 from it); the TPU kernels in
interpret mode are held at the atol 2e-2 of the reference's own int8
cases (they fold the scale into bf16 weights, or scale the row sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roadsurf_tpu.ops.roi_align import _level_assignment as j_level
from roadsurf_tpu.ops.roi_align import _roi_align_separable as j_separable
from roadsurf_tpu.ops.roi_align import roi_align_multilevel as j_roi_align
from roadsurf_tpu_torch.ops.roi_align import reachable_levels, \
    roi_align_multilevel
from roadsurf_tpu_torch.ops.roi_align_blocked_kernel import \
    roi_align_fused_blocked_ref
from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused_ref

torch.set_num_threads(1)


def _int8_levels(rng, sides, C, scales, B=2):
    """Standard-normal levels quantized in ``scales``, as the reference's
    own int8 pooler tests make them."""
    return [np.clip(np.round(rng.normal(size=(B, s, s, C)) / sc), -127,
                    127).astype(np.int8) for s, sc in zip(sides, scales)]


def _boxes(rng, B, R, S):
    x0, y0 = rng.uniform(0, S - 4, (2, B, R))
    w, h = rng.uniform(1, S / 2, (2, B, R))
    return np.stack([x0, y0, np.minimum(x0 + w, S), np.minimum(y0 + h, S)],
                    -1).astype(np.float32)


@pytest.mark.parametrize("S,sampling", [(256, 2), (256, 0), (704, 2)])
def test_int8_pooler_plain_matches_jax_xla_path(S, sampling):
    """K1's (256 px, s=2) and K2's (256 px adaptive; 704 px, where P2 is
    above 160², at s=2) plain versions on int8 levels: against JAX's
    separable path on the dequantized levels in float32 (atol 1e-5), and
    against JAX's XLA path with feat_scales, which rounds its weights and
    row sums to bf16 (rtol 2⁻⁶, atol 2e-2)."""
    rng = np.random.default_rng(S + sampling)
    scales = np.asarray([0.05, 0.08, 0.11, 0.07], np.float32)
    q = _int8_levels(rng, [S // 4, S // 8, S // 16, S // 32], 8, scales)
    boxes = _boxes(rng, 2, 9, S)
    got = roi_align_multilevel([torch.from_numpy(f) for f in q],
                               torch.from_numpy(boxes), 7, sampling=sampling,
                               feat_scales=torch.from_numpy(scales))
    assert got.dtype == torch.float32 and got.shape == (2, 9, 7, 7, 8)
    n = reachable_levels([torch.from_numpy(f) for f in q])
    dq = [(jnp.asarray(f).astype(jnp.float32) * s).astype(jnp.bfloat16)
          .astype(jnp.float32) for f, s in zip(q[:n], scales)]
    lvl = j_level(jnp.asarray(boxes), 224, 4, 2, 2 + n - 1)
    ref = np.asarray(j_separable(dq, jnp.asarray(boxes), lvl, 7, sampling, 2))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    xla = np.asarray(j_roi_align([jnp.asarray(f) for f in q],
                                 jnp.asarray(boxes), 7, sampling=sampling,
                                 feat_scales=jnp.asarray(scales)))
    np.testing.assert_allclose(got.numpy(), xla, rtol=2 ** -6, atol=2e-2)


def test_k1_int8_plain_matches_tpu_kernel_interpreted():
    """K1's plain version against roi_align_fused(interpret=True,
    feat_scales=...), which folds the scale into its bf16 weights, on the
    inputs of the reference's own int8 case (tests/test_model.py:202-241,
    atol 2e-2)."""
    from roadsurf_tpu.ops.roi_align_pallas import roi_align_fused
    rng = np.random.default_rng(5)
    B, R, C, S = 2, 8, 8, 64
    scales = np.asarray([0.11, 0.23, 0.47], np.float32)
    feats = [rng.normal(size=(B, S // st, S // st, C)) for st in (4, 8, 16)]
    q = [np.clip(np.round(np.asarray(jnp.asarray(f, jnp.bfloat16)
                                     .astype(jnp.float32)) / s), -127, 127)
         .astype(np.int8) for f, s in zip(feats, scales)]
    x0, y0 = rng.uniform(0, 50, (2, B, R))
    w, h = rng.uniform(4, 40, (2, B, R))
    boxes = np.stack([x0, y0, np.minimum(x0 + w, S), np.minimum(y0 + h, S)],
                     -1).astype(np.float32)
    lvl = torch.from_numpy(np.asarray(j_level(jnp.asarray(boxes), 224, 4, 2,
                                              4))).int()
    got = roi_align_fused_ref(tuple(torch.from_numpy(f) for f in q),
                              torch.from_numpy(boxes), lvl, 7, 2,
                              feat_scales=torch.from_numpy(scales))
    ref = np.asarray(roi_align_fused(tuple(jnp.asarray(f) for f in q),
                                     jnp.asarray(boxes), 7, interpret=True,
                                     feat_scales=jnp.asarray(scales)),
                     np.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2)


@pytest.mark.parametrize("sampling", [
    0, pytest.param(2, marks=pytest.mark.slow)])
def test_k2_int8_plain_matches_tpu_kernel_interpreted(sampling):
    """K2's plain version against roi_align_fused_blocked(interpret=True,
    feat_scales=...), which scales its accumulated rows: atol 2e-2 (the
    bound of tests/test_model.py's int8 case)."""
    from roadsurf_tpu.ops.roi_align_pallas import roi_align_fused_blocked
    rng = np.random.default_rng(6 + sampling)
    scales = np.asarray([0.05, 0.08, 0.11, 0.07], np.float32)
    q = _int8_levels(rng, [88, 44, 22, 11], 16, scales, B=1)
    boxes = _boxes(rng, 1, 6, 352)
    lvl = torch.from_numpy(np.asarray(j_level(jnp.asarray(boxes), 224, 4, 2,
                                              5))).int()
    got = roi_align_fused_blocked_ref(tuple(torch.from_numpy(f) for f in q),
                                      torch.from_numpy(boxes), lvl, 7,
                                      sampling,
                                      feat_scales=torch.from_numpy(scales))
    ref = np.asarray(roi_align_fused_blocked(
        tuple(jnp.asarray(f) for f in q), jnp.asarray(boxes), 7,
        sampling=sampling, interpret=True, out_dtype=jnp.float32,
        feat_scales=tuple(scales.tolist())))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2)
