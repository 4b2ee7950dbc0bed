"""The weight bridge: the JAX package's parameter tree -> the PyTorch port's
state, every leaf consumed and every layout move pinned."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from roadsurf_tpu.models import fast_profile
from roadsurf_tpu.models import init_params as jax_init_params
from roadsurf_tpu.models.fpn import init_fpn
from roadsurf_tpu.models.resnet import init_resnet
from roadsurf_tpu.models.roi_heads import init_box_head, init_mask_head
from roadsurf_tpu.models.rpn import init_rpn
from roadsurf_tpu.utils.checkpoint import save_params
from roadsurf_tpu_torch.models import init_params as torch_init_params
from roadsurf_tpu_torch.utils.weights import from_jax_params, load_params

torch.set_num_threads(1)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


NARROW = dict(fpn_channels=32, box_fc_dim=64, mask_conv_dim=32)


@pytest.fixture(scope="module")
def jax_tree():
    """A random tree of the reference's init_params schema at a narrow
    width (its builders' paths and shapes, the ResNet-50 depth), values
    from a numpy seed."""
    cfg = fast_profile().__class__(**NARROW)

    def init(key):
        k = jax.random.split(key, 5)
        return {"backbone": init_resnet(k[0], stem_out=16, res2_out=32),
                "fpn": init_fpn(k[1], in_channels=(32, 64, 128, 256),
                                out_channels=32),
                "rpn": init_rpn(k[2], 32, cfg.num_anchors),
                "box_head": init_box_head(k[3], cfg, 32),
                "mask_head": init_mask_head(k[4], cfg, 32)}

    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        jax.eval_shape(init, jax.random.PRNGKey(3)))


def test_from_jax_params_consumes_every_leaf_and_moves_layouts(jax_tree):
    tree = jax_tree
    state = from_jax_params(tree)

    n_in = len(_leaves(tree))
    # FrozenBN units {w, scale, bias} fold into {w, b}: one leaf fewer each
    n_units = 1 + sum(len(bp) for s in ("res2", "res3", "res4", "res5")
                      for bp in tree["backbone"][s])
    n_out = len(jax.tree_util.tree_leaves(state))
    assert n_out == n_in - n_units

    stem = tree["backbone"]["stem"]
    np.testing.assert_array_equal(
        state["backbone"]["stem"]["w"].numpy(),
        (stem["w"] * stem["scale"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["backbone"]["stem"]["b"].numpy(),
                                  stem["bias"])
    assert [len(state["backbone"][s]) for s in ("res2", "res3", "res4",
                                                "res5")] == [3, 4, 6, 3]
    assert "shortcut" in state["backbone"]["res3"][0]
    assert "shortcut" not in state["backbone"]["res3"][1]
    fc1 = tree["box_head"]["fc1"]["w"]
    np.testing.assert_array_equal(state["box_head"]["fc1"]["w"].numpy(),
                                  fc1.T)
    assert state["fpn"]["output3"]["w"].shape == (32, 32, 3, 3)
    assert state["mask_head"]["predictor"]["w"].shape == (2, 32, 1, 1)

    extra = dict(tree, quant={"backbone": {"w": np.zeros(3, np.float32)}})
    with pytest.raises(ValueError, match="quant/backbone/w"):
        from_jax_params(extra)
    missing = dict(tree, rpn={k: v for k, v in tree["rpn"].items()
                              if k != "deltas"})
    with pytest.raises(KeyError, match="rpn/deltas/w"):
        from_jax_params(missing)


def test_npz_checkpoint_round_trip(jax_tree, tmp_path):
    """The reference's .npz writer -> the port's reader gives the same
    state as converting the tree directly."""
    path = save_params(str(tmp_path / "model_0000007.npz"), jax_tree,
                       step=7)
    tree, step = load_params(path)
    assert step == 7
    a = jax.tree_util.tree_leaves(from_jax_params(tree))
    b = jax.tree_util.tree_leaves(from_jax_params(jax_tree))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_deconv_permutation_pinned_by_conv_transpose(jax_tree):
    """in == out, so a wrong permutation keeps the shape: compare one
    ConvTranspose2d output with the reference's conv_transpose."""
    rng = np.random.default_rng(4)
    C = 32
    w = rng.normal(size=(2, 2, C, C)).astype(np.float32)   # (kh, kw, out, in)
    x = rng.normal(size=(2, 5, 5, C)).astype(np.float32)   # NHWC
    ref = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), strides=(2, 2), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), transpose_kernel=True))
    tree = jax.tree.map(lambda a: a, jax_tree)
    tree["mask_head"]["deconv"] = {"w": w, "b": np.zeros(C, np.float32)}
    tw = from_jax_params(tree)["mask_head"]["deconv"]["w"]
    got = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), tw,
                             stride=2).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 10, 10, C)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # the transposed kernel really differs: a swapped in/out would fail
    bad = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                             tw.transpose(0, 1), stride=2)
    assert not np.allclose(bad.permute(0, 2, 3, 1).numpy(), ref, atol=1e-3)


def test_torch_init_params_has_the_reference_schema():
    """The port's own init draws a tree of the reference's schema (paths
    and shapes of its init_params at full width), which the bridge
    converts with every leaf consumed."""
    cfg = fast_profile()
    ref = jax.eval_shape(lambda k: jax_init_params(k, cfg),
                         jax.random.PRNGKey(0))
    tree = torch_init_params(cfg, torch.Generator().manual_seed(0))
    ref_paths = {(jax.tree_util.keystr(p), tuple(v.shape))
                 for p, v in _leaves(ref)}
    got_paths = {(jax.tree_util.keystr(p), tuple(v.shape))
                 for p, v in _leaves(tree)}
    assert got_paths == ref_paths
    from_jax_params(tree)
