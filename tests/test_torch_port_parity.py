"""The parity profile of the PyTorch port against the JAX package, in
float32 at a narrow width, on the CPU.

The parity profile is the configuration ``scripts/make_detections.py``
builds from the repository's detectron2 YAML
(``config/detectron2_config_3bands.yaml``): tiles resized to
MIN_SIZE_TEST, adaptive pooler sampling (POOLER_SAMPLING_RATIO 0), 1000
pre- and post-NMS proposals, 100 detections, exact greedy NMS. Here it runs
through the resize path with reduced top-k budgets: at 1000 to 2000
candidates two scores 1e-7 apart can swap under f32 reassociation, so the
tests assert that their top scores lie further apart than the score
tolerance, and a failure says which it is. The real geometry (256 -> 800,
1000/1000 proposals, 100 detections) runs in a slow-marked test.

Tolerances are those of tests/test_torch_port_model.py: valid and classes
exact, boxes 1e-4 px, scores 1e-6, mask logits 1e-4.
"""

import os
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax

from roadsurf_tpu.models.config import from_detectron2_yaml as \
    j_from_yaml
from roadsurf_tpu.models.mask_rcnn import forward_inference as jax_forward
from roadsurf_tpu_torch.engine import TileInferenceEngine
from roadsurf_tpu_torch.models import forward_inference
from roadsurf_tpu_torch.models.config import from_detectron2_yaml
from roadsurf_tpu_torch.ops.roi_align import reachable_levels
from roadsurf_tpu_torch.utils.weights import from_jax_params
from test_torch_port_model import _compare, narrow_tree

torch.set_num_threads(1)

YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "detectron2_config_3bands.yaml")
NARROW = {"fpn_channels": 32, "box_fc_dim": 64, "mask_conv_dim": 32,
          "compute_dtype": "float32"}


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


def parity_cfgs(S: int, pre: int, post: int, D: int):
    """(JAX config, port config): the YAML's, at a narrow width and f32,
    tiles resized to S, with the given top-k budgets."""
    knobs = dict(NARROW, min_size_test=S, max_size_test=S,
                 rpn_pre_nms_topk_test=pre, rpn_post_nms_topk_test=post,
                 detections_per_image=D)
    return replace(j_from_yaml(YAML), **knobs), \
        replace(from_detectron2_yaml(YAML), **knobs)


def test_yaml_config_equals_the_reference_field_for_field():
    got, ref = from_detectron2_yaml(YAML), j_from_yaml(YAML)
    assert asdict(got) == asdict(ref)
    assert (got.min_size_test, got.pooler_sampling_ratio,
            got.rpn_pre_nms_topk_test, got.rpn_post_nms_topk_test,
            got.detections_per_image, got.fast_nms) \
        == (800, 0, 1000, 1000, 100, False)


def test_all_four_pooling_levels_are_reachable_at_800_px():
    feats = [torch.empty((1, 800 // s, 800 // s, 1), device="meta")
             for s in (4, 8, 16, 32)]
    assert [f.shape[1] for f in feats] == [200, 100, 50, 25]
    assert reachable_levels(feats) == 4


def _separated(scores: np.ndarray, valid: np.ndarray, tol: float):
    """Every image's valid detection scores lie more than ``tol`` apart,
    so no pair can swap within the score tolerance."""
    for s, v in zip(scores, valid):
        gaps = np.diff(np.sort(s[v]))
        assert gaps.size == 0 or gaps.min() > tol, gaps.min()


def _run_both(native: int, S: int, pre: int, post: int, D: int, B: int):
    jcfg, tcfg = parity_cfgs(S, pre, post, D)
    tree = narrow_tree(jcfg)
    imgs = np.random.default_rng(1).integers(0, 255,
                                             (B, native, native, 3),
                                             np.uint8)
    ref = jax.jit(lambda p, x: jax_forward(p, x, jcfg))(tree, imgs)
    got = forward_inference(from_jax_params(tree), imgs, tcfg, device="cpu")
    return got, ref


def test_parity_forward_matches_jax_in_f32():
    """112 -> 224 px (the resize path; P2..P4 reachable), exact NMS,
    adaptive sampling, 200 pre-NMS / 100 post-NMS proposals a level, 20
    detections."""
    got, ref = _run_both(112, 224, 200, 100, 20, 2)
    _separated(np.asarray(ref["scores"]), np.asarray(ref["valid"]), 1e-6)
    _compare(got, ref)
    assert got["boxes"].shape == (2, 20, 4)
    assert got["mask_logits"].shape == (2, 20, 28, 28)


@pytest.mark.slow
def test_parity_forward_matches_jax_at_the_real_geometry():
    """256 -> 800 px, 1000 pre- and post-NMS proposals, 100 detections,
    B = 1, narrow width: the YAML's geometry."""
    got, ref = _run_both(256, 800, 1000, 1000, 100, 1)
    _separated(np.asarray(ref["scores"]), np.asarray(ref["valid"]), 1e-6)
    _compare(got, ref)
    assert got["boxes"].shape == (1, 100, 4)


def test_dense_profile_forward_matches_jax_in_f32():
    """The dense profile, the one configuration that pairs the fixed-grid
    pooler (K1's plain version, s = 2) with exact greedy NMS (K3's): 1024
    pre-NMS candidates a level, 256 proposals, 16 detections, at 64 px and
    a narrow width in f32 (the bf16 stack's row of the tolerances)."""
    from roadsurf_tpu.models.config import dense_profile as j_dense
    from roadsurf_tpu_torch.models import dense_profile

    knobs = dict(fpn_channels=32, box_fc_dim=64, mask_conv_dim=32,
                 min_size_test=64, max_size_test=64, compute_dtype="float32")
    jcfg, tcfg = replace(j_dense(), **knobs), replace(dense_profile(), **knobs)
    assert asdict(jcfg) == asdict(tcfg)
    assert (tcfg.pooler_sampling_ratio, tcfg.fast_nms,
            tcfg.rpn_pre_nms_topk_test, tcfg.rpn_post_nms_topk_test,
            tcfg.detections_per_image) == (2, False, 1024, 256, 16)
    tree = narrow_tree(jcfg)
    imgs = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 3),
                                             np.uint8)
    ref = jax.jit(lambda p, x: jax_forward(p, x, jcfg))(tree, imgs)
    got = forward_inference(from_jax_params(tree), imgs, tcfg, device="cpu")
    _separated(np.asarray(ref["scores"]), np.asarray(ref["valid"]), 1e-6)
    _compare(got, ref)
    assert got["boxes"].shape == (2, 16, 4)
    assert got["mask_logits"].shape == (2, 16, 28, 28)


def test_engine_runs_the_parity_config_and_pads_and_trims_like_the_forward():
    """The CPU engine on the YAML's configuration (48 -> 96 px, bits): a
    short tail batch is padded and trimmed, and the packed fetch unpacks
    to the forward's own outputs."""
    jcfg, cfg = parity_cfgs(96, 100, 50, 10)
    state = from_jax_params(narrow_tree(jcfg))
    imgs = np.random.default_rng(2).integers(0, 255, (5, 48, 48, 3),
                                             np.uint8)
    eng = TileInferenceEngine(state, cfg, batch_size=2, in_flight=1,
                              mask_format="bits", device="cpu")
    outs = list(eng.run([imgs[0:2], imgs[2:4], imgs[4:5]]))
    assert [o["valid"].shape[0] for o in outs] == [2, 2, 1]
    assert eng.tiles_seen == 5
    assert outs[0]["mask_bits"].shape == (2, 10, 98)
    assert any(o["valid"].any() for o in outs)
    padded = np.concatenate([imgs, np.zeros_like(imgs[:1])])
    for o, b in zip(outs, range(3)):
        ref = forward_inference(state, padded[2 * b:2 * b + 2], cfg,
                                mask_format="bits", device="cpu")
        n = o["valid"].shape[0]
        assert sorted(o) == sorted(ref)
        for k, v in ref.items():
            assert o[k].dtype == v.numpy().dtype, k
            np.testing.assert_array_equal(o[k], v.numpy()[:n], err_msg=k)
