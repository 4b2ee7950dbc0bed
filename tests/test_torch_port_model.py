"""The whole fast-profile slice of the PyTorch port against the JAX
package's ``forward_inference``, in float32 at a narrow width, on the CPU.

Tolerances (f32; the two packages' conv and matmul libraries sum in other
orders, ~1e-7 relative per layer through ~60 layers; the mask logits here
reach magnitudes of ~6):
* ``valid`` and ``classes``: exact;
* boxes: atol 1e-4 px on a 64 px image; scores: atol 1e-6;
* mask logits: atol 1e-4;
* ``bits``: exact wherever |logit| > 1e-3 (a cell closer to the 0.5
  threshold may fall either side).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from roadsurf_tpu.models import fast_profile
from roadsurf_tpu.models.fpn import init_fpn
from roadsurf_tpu.models.mask_rcnn import forward_inference as jax_forward
from roadsurf_tpu.models.resnet import init_resnet
from roadsurf_tpu.models.roi_heads import init_box_head, init_mask_head
from roadsurf_tpu.models.rpn import init_rpn
from roadsurf_tpu_torch.engine import TileInferenceEngine
from roadsurf_tpu_torch.models import forward_inference
from roadsurf_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_tf32():
    """Full float32 products wherever TF32 could apply."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def narrow_cfg(S: int):
    return replace(fast_profile(post_nms_topk=32), fpn_channels=32,
                   box_fc_dim=64, mask_conv_dim=32, min_size_test=S,
                   max_size_test=S, compute_dtype="float32")


def narrow_tree(cfg, seed: int = 0) -> dict:
    """A tree of the reference's init_params schema at a narrow width
    (ResNet-50 depth, stem 16, res2 32, FPN 32), values from a numpy
    seed: He-scaled weights, non-zero FrozenBN scales — the conv3 scales
    the reference zero-inits included, so the residual branches compute —
    and non-zero biases."""
    def init(key):
        k = jax.random.split(key, 5)
        return {"backbone": init_resnet(k[0], stem_out=16, res2_out=32),
                "fpn": init_fpn(k[1], in_channels=(32, 64, 128, 256),
                                out_channels=32),
                "rpn": init_rpn(k[2], 32, cfg.num_anchors),
                "box_head": init_box_head(k[3], cfg, 32),
                "mask_head": init_mask_head(k[4], cfg, 32)}

    rng = np.random.default_rng(seed)
    # box and proposal regressors stay near identity, as the reference
    # initializes them, so boxes stay inside the image
    small = {("box_head", "bbox"): 1e-3, ("rpn", "deltas"): 1e-2}

    def fill(path, a):
        name = path[-1].key
        group = (path[0].key, path[1].key)
        if name == "w" and group in small:
            v = rng.normal(size=a.shape) * small[group]
        elif name == "w":
            fan = a.shape[0] * a.shape[1] * a.shape[3] if len(a.shape) == 4 \
                else a.shape[0]
            v = rng.normal(size=a.shape) * np.sqrt((2.0 if len(a.shape) == 4
                                                    else 1.0) / fan)
        elif name == "scale":
            # the stem takes 0..255-scale pixels; residual branches add
            # up over 16 blocks: keep activations of order 1
            lo = 0.005 if group == ("backbone", "stem") else \
                0.1 if path[-2].key == "conv3" else 0.5
            v = rng.uniform(lo, 2 * lo, a.shape)
        else:                                  # "b" / "bias"
            v = rng.normal(0.0, 0.1 if group not in small else 1e-3,
                           a.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _compare(got: dict, ref: dict):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert got["valid"].any()
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-4)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-6)
    if "mask_logits" in ref:
        assert got["mask_logits"].dtype == np.float32
        np.testing.assert_allclose(got["mask_logits"], ref["mask_logits"],
                                   atol=1e-4)


@pytest.mark.parametrize("native,S", [(64, 64), (48, 64)])
def test_forward_matches_jax_in_f32(native, S):
    """(64, 64): the fast profile's native-size path; (48, 64): the
    preprocess resize path (S != native)."""
    cfg = narrow_cfg(S)
    tree = narrow_tree(cfg)
    imgs = np.random.default_rng(1).integers(0, 255, (2, native, native, 3),
                                             np.uint8)
    ref = jax.jit(lambda p, x: jax_forward(p, x, cfg))(tree, imgs)
    got = forward_inference(from_jax_params(tree), imgs, cfg, device="cpu")
    _compare(got, ref)
    assert got["boxes"].shape == (2, 8, 4)
    assert got["mask_logits"].shape == (2, 8, 28, 28)


def test_mask_formats_bits_and_u8():
    """bits: threshold at 0 and pack little-endian, exact against the
    reference's bits wherever the logit is clear of 0; u8 from the same
    logits."""
    cfg = narrow_cfg(64)
    tree = narrow_tree(cfg)
    imgs = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 3),
                                             np.uint8)
    ref = jax.jit(lambda p, x: jax_forward(p, x, cfg, mask_format="bits"))(
        tree, imgs)
    state = from_jax_params(tree)
    got = forward_inference(state, imgs, cfg, mask_format="bits",
                            device="cpu")
    both = forward_inference(state, imgs, cfg, mask_format="both",
                             device="cpu")
    _compare({k: v for k, v in got.items() if k != "mask_bits"},
             {k: v for k, v in ref.items() if k != "mask_bits"})
    logits = both["mask_logits"].numpy()
    clear = np.abs(logits.reshape(2, 8, -1)) > 1e-3
    bits_got = np.unpackbits(got["mask_bits"].numpy(), axis=-1,
                             bitorder="little")
    bits_ref = np.unpackbits(np.asarray(ref["mask_bits"]), axis=-1,
                             bitorder="little")
    assert got["mask_bits"].shape == (2, 8, 98)
    np.testing.assert_array_equal(bits_got[clear], bits_ref[clear])
    np.testing.assert_array_equal(bits_got.reshape(2, 8, 28, 28),
                                  (logits >= 0).astype(np.uint8))
    u8 = both["mask_probs_u8"].numpy()
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(
        u8, np.round(1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
                     * 255.0).astype(np.uint8))


def test_engine_pads_trims_and_unpacks_like_the_forward():
    """The CPU engine: a short tail batch is padded and trimmed, and the
    packed single-buffer fetch unpacks to the forward's own outputs."""
    cfg = narrow_cfg(64)
    state = from_jax_params(narrow_tree(cfg))
    imgs = np.random.default_rng(2).integers(0, 255, (5, 64, 64, 3),
                                             np.uint8)
    eng = TileInferenceEngine(state, cfg, batch_size=2, in_flight=1,
                              mask_format="bits", device="cpu")
    outs = list(eng.run([imgs[0:2], imgs[2:4], imgs[4:5]]))
    assert [o["valid"].shape[0] for o in outs] == [2, 2, 1]
    assert eng.tiles_seen == 5
    assert set(eng.stats) == {"h2d_s", "d2h_s", "unpack_s"}
    padded = np.concatenate([imgs, np.zeros_like(imgs[:1])])
    for o, b in zip(outs, range(3)):
        # the forward of the padded batch, trimmed: same batch shape, same
        # arithmetic
        ref = forward_inference(state, padded[2 * b:2 * b + 2], cfg,
                                mask_format="bits", device="cpu")
        n = o["valid"].shape[0]
        assert sorted(o) == sorted(ref)
        for k, v in ref.items():
            assert o[k].dtype == v.numpy().dtype, k
            np.testing.assert_array_equal(o[k], v.numpy()[:n], err_msg=k)
