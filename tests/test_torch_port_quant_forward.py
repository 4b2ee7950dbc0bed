"""The whole static-int8 forward of the PyTorch port against the JAX
package's, on the CPU at a narrow width: the fast profile at 64 px native
(the uint8-direct stem) in each int8 scope, the parity profile (112 -> 224
px, the calibrated stem, adaptive sampling, exact NMS) in int8 full +
pyramid, the engine, and (slow-marked) the parity profile's real 800 px
geometry. The reference's quant tree comes from its own prepare_quantized
(``Setup`` in ``tests/test_torch_port_quant.py``) and is loaded by
``from_jax_quant``. Tolerances: ``_compare_int8``.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadsurf_tpu.models.config import from_detectron2_yaml as j_from_yaml
from roadsurf_tpu.models.mask_rcnn import forward_inference as jax_forward
from roadsurf_tpu_torch.engine import TileInferenceEngine
from roadsurf_tpu_torch.models import forward_inference
from roadsurf_tpu_torch.utils.weights import from_jax_quant
from test_torch_port_quant import INT8, YAML, Setup, _no_tf32, fast, \
    parity  # noqa: F401  (fixtures)

torch.set_num_threads(1)


def _compare_int8(got: dict, ref: dict, mask_atol: float = 1e-4,
                  mask_flips: float = 0.0):
    """valid and classes exact; boxes atol 1e-4 px, scores atol 1e-6,
    mask logits atol 1e-4 — the float32 tolerances of the port's other
    forward tests: with the reference compiled as written (see
    ``_forward_both``) every int8 value agrees, and what is left is the
    float32 summation order of the convs in the compute dtype and of the
    poolers. Two widenings, each where it is used: ``mask_atol`` for a
    float mask head on bf16 levels (a pooled value on a bf16 rounding
    boundary moves by 2⁻⁸ of itself), and ``mask_flips``, the share of
    mask logits allowed beyond ``mask_atol`` (each at most 0.5 off), where
    the poolers' summation order moves a pooled value across an int8
    rounding boundary of the mask stream."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert got["valid"].any()
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-4)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-6)
    err = np.abs(got["mask_logits"] - ref["mask_logits"])
    assert (err > mask_atol).mean() <= mask_flips, (err > mask_atol).mean()
    assert err.max() <= (0.5 if mask_flips else mask_atol), err.max()


@pytest.fixture
def f32_pooling(monkeypatch):
    """The reference's heads pool in float32, as the port's plain versions
    do: its XLA path casts its weights and row sums to the levels' bf16
    (int8 levels dequantize to bf16 first), which the port's kernels and
    plain versions do not. The output keeps the reference's dtype rule
    (float32 from int8 levels, the levels' dtype otherwise)."""
    import roadsurf_tpu.models.roi_heads as jheads

    orig = jheads.roi_align_multilevel

    def pool(feats, boxes, out_size, feat_scales=None, **kw):
        kw["use_pallas"] = False
        if feat_scales is not None:
            scl = jnp.asarray(feat_scales, jnp.float32)
            feats = [(f.astype(jnp.float32) * scl[i]).astype(jnp.bfloat16)
                     for i, f in enumerate(feats)]
            dtype = jnp.float32
        else:
            dtype = feats[0].dtype
        return orig([f.astype(jnp.float32) for f in feats], boxes, out_size,
                     **kw).astype(dtype)

    monkeypatch.setattr(jheads, "roi_align_multilevel", pool)


def _forward_both(s, cfg, quant):
    """(port, reference) outputs. The reference is compiled without XLA's
    fusion pass: inside a fusion the CPU backend contracts ``y·mult +
    bias`` (and the residual ``out + x·sa``) into fused multiply-adds, one
    rounding where the reference's code has two, which moves values across
    int8 rounding boundaries."""
    params = dict(s.tree, quant=quant)
    ref = jax.jit(lambda p, x: jax_forward(p, x, cfg)).lower(
        params, s.imgs).compile(compiler_options={
            "xla_disable_hlo_passes": "fusion",
            "xla_allow_excess_precision": False})(params, s.imgs)
    state = dict(s.state, quant=from_jax_quant(quant))
    return forward_inference(state, s.imgs, cfg, device="cpu"), ref


@pytest.mark.parametrize("scope", ["full+pyramid", "full", "convnet",
                                   "backbone"])
def test_int8_forward_matches_jax_fast(scope, fast, f32_pooling):
    """The fast profile at 64 px native (uint8-direct stem) in each scope,
    on the reference's quant tree cut to what its prepare_quantized returns
    for that scope."""
    groups = {"full+pyramid": None, "full": ("backbone", "fpn", "rpn", "box",
                                             "mask"),
              "convnet": ("backbone", "fpn", "rpn"),
              "backbone": ("backbone",)}[scope]
    quant = fast.jquant if groups is None else {g: fast.jquant[g]
                                                for g in groups}
    cfg = replace(fast.cfg, int8_scope=scope.split("+")[0],
                  int8_pyramid=groups is None)
    got, ref = _forward_both(fast, cfg, quant)
    _compare_int8(got, ref, mask_atol=5e-3 if scope == "convnet" else 1e-4)


def test_int8_forward_matches_jax_parity(parity, f32_pooling):
    """The parity profile (112 -> 224: the calibrated stem, adaptive
    sampling, exact NMS) in int8 full + pyramid."""
    got, ref = _forward_both(parity, parity.cfg, parity.jquant)
    _compare_int8(got, ref)
    assert got["boxes"].shape == (2, 20, 4)


def test_int8_engine_equals_the_forward(fast):
    """The engine carries and places the quant tree (int8 weights, float32
    scales kept) and gives the forward's outputs for each padded batch."""
    state = dict(fast.state, quant=from_jax_quant(fast.jquant))
    imgs = np.random.default_rng(2).integers(0, 255, (3, 64, 64, 3),
                                             np.uint8)
    eng = TileInferenceEngine(state, fast.cfg, batch_size=2, in_flight=1,
                              mask_format="bits", device="cpu")
    q = eng.state["quant"]
    assert q["backbone"]["stem"]["wq"].dtype == torch.int8
    assert q["box"]["fc1"]["mult"].dtype == torch.float32
    outs = list(eng.run([imgs[0:2], imgs[2:3]]))
    padded = np.concatenate([imgs, np.zeros_like(imgs[:1])])
    for o, b in zip(outs, range(2)):
        ref = forward_inference(state, padded[2 * b:2 * b + 2], fast.cfg,
                                mask_format="bits", device="cpu")
        n = o["valid"].shape[0]
        for k, v in ref.items():
            np.testing.assert_array_equal(o[k], v.numpy()[:n], err_msg=k)


@pytest.mark.slow
def test_int8_forward_matches_jax_at_the_real_parity_geometry(f32_pooling):
    """256 -> 800 px, 1000/1000 proposals, 100 detections, B = 2, narrow
    width, int8 full + pyramid calibrated by the reference."""
    cfg = replace(j_from_yaml(YAML), fpn_channels=32, box_fc_dim=64,
                  mask_conv_dim=32, compute_dtype="float32", **INT8)
    s = Setup(cfg, 256)
    got, ref = _forward_both(s, cfg, s.jquant)
    _compare_int8(got, ref, mask_flips=5e-3)
    assert got["boxes"].shape == (2, 100, 4)
