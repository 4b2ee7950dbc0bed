"""The training step of the PyTorch port against the JAX package's, on the
CPU in float32 at a narrow width: ``compute_losses`` and one
``make_train_step`` update on the fast profile at 64 px (fixed 2x2 pooler
sampling, the sweep NMS), from the same parameters, batch and sampling
draws; and the port's own knobs (``train_head_chunks``, ``train_remat``,
``train_mask_rois``), which only regroup the same arithmetic.

The reference draws its samples with ``jax.random`` from ``fold_in(
fold_in(PRNGKey(0), seed), step)``; :func:`jax_draws` repeats its key tree
(``engine/train.py:171,63,215-217,251-257``) and hands the same uniforms
to the port.

Tolerances: the losses rtol 1e-5 (atol 1e-6); the update, per leaf:
the velocity (g + wd·p after one step) |v_port − v_ref| ≤ 1e-4·max|v_ref|
(gradients through ~60 f32 layers summed in other orders; the ROI and
anchor choices, and so every selection, are exact), and the parameters'
move within that plus one ulp of the parameter (the f32 step p − lr·v
rounds to a neighbour); frozen leaves and their velocity unchanged bit
for bit; the knobs rtol 1e-6.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadsurf_tpu.engine import train as jt
from roadsurf_tpu.models import fast_profile as j_fast
from roadsurf_tpu_torch.engine import train as tt
from roadsurf_tpu_torch.models import fast_profile
from roadsurf_tpu_torch.utils.weights import from_jax_train_params, \
    to_jax_params
from test_torch_port_model import narrow_tree

torch.set_num_threads(1)

NARROW = {"fpn_channels": 32, "box_fc_dim": 64, "mask_conv_dim": 32,
          "compute_dtype": "float32"}
SEED = 7
LOSS_RTOL, LOSS_ATOL, STEP_TOL = 1e-5, 1e-6, 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def fast_cfgs(S: int = 64):
    knobs = dict(NARROW, min_size_test=S, max_size_test=S,
                 roi_batch_per_image=32, rpn_batch_per_image=16)
    return replace(j_fast(post_nms_topk=32), **knobs), \
        replace(fast_profile(post_nms_topk=32), **knobs)


def make_batch(S: int, B: int = 2, G: int = 4, seed: int = 3) -> dict:
    """Random tiles and padded GT of both classes: 2 or 3 boxes an image
    (20x16 px, masks filling them), the rest zero rows."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    masks = np.zeros((B, G, S, S), np.uint8)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        for g in range(2 + b % 2):
            x0, y0 = rng.uniform(2, S - 24, 2)
            w, h = rng.uniform(0.2, 0.45, 2) * S
            boxes[b, g] = (x0, y0, min(x0 + w, S), min(y0 + h, S))
            masks[b, g, int(y0):int(y0 + h), int(x0):int(x0 + w)] = 1
            valid[b, g] = True
    return {"image": rng.integers(0, 255, (B, S, S, 3), np.uint8),
            "gt_boxes": boxes,
            "gt_classes": rng.integers(0, 2, (B, G)).astype(np.int32),
            "gt_valid": valid, "gt_masks": masks}


def jax_draws(key, tcfg, S: int, B: int, G: int) -> dict:
    """The uniforms the reference's ``compute_losses`` draws from ``key``,
    as the port's ``draws`` (B, n) tensors."""
    sizes = tt.sample_sizes(tcfg, S, G)
    keys = jax.random.split(key, 2 * B + 2)
    d = {k: [] for k in sizes}

    def u(k, name):
        d[name].append(np.asarray(jax.random.uniform(k, (sizes[name],))))

    for b in range(B):
        kp, kn = jax.random.split(keys[b])
        u(kp, "rpn_pos")
        u(kn, "rpn_neg")
        k1, k2 = jax.random.split(keys[B + b])
        kp, kn = jax.random.split(k1)
        u(kp, "roi_pos")
        u(kn, "roi_neg")
        u(k2, "roi_pick")
    for k in jax.random.split(keys[2 * B], B):
        u(k, "mask_pick")
    return {k: torch.from_numpy(np.stack(v)) for k, v in d.items()}


def step_key(step: int):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                 SEED), step)


def torch_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    out["gt_classes"] = out["gt_classes"].long()
    return out


def check_step(jcfg, tcfg, S: int, B: int = 2):
    """One step of both packages from the same state: the losses, then
    each leaf's update (frozen leaves bit for bit)."""
    tree = narrow_tree(jcfg)
    batch = make_batch(S, B)
    G = batch["gt_boxes"].shape[1]
    ref_state = {"params": tree,
                 "velocity": jax.tree.map(np.zeros_like, tree),
                 "step": jnp.zeros((), jnp.int32),
                 "seed": jnp.asarray(SEED, jnp.int32)}
    new_ref, ref_m = jax.jit(jt.make_train_step(jcfg, S))(ref_state, batch)
    state = tt.init_train_state(from_jax_train_params(tree), tcfg,
                                seed=SEED, device="cpu")
    got_m = tt.train_step(tcfg, S)(state, torch_batch(batch),
                                   jax_draws(step_key(0), tcfg, S, B, G))
    assert state["step"] == 1
    return compare_step(jcfg, tree, new_ref, ref_m, got_m,
                        to_jax_params(state["params"]),
                        to_jax_params(state["velocity"]))


def compare_step(jcfg, tree, new_ref, ref_m, got_m, got_params,
                 got_velocity):
    """The port's step (its metrics, and its parameters and velocity in
    the reference's schema) against the reference's from the same
    ``tree``: the losses, then each leaf's update (frozen leaves bit for
    bit). Returns the worst relative velocity error."""
    for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
              "loss_mask", "total", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    assert float(ref_m["loss_mask"]) > 0 and float(ref_m["loss_box_reg"]) > 0

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    leaves = jax.tree_util.tree_leaves
    new_p, new_v = leaves(new_ref["params"]), leaves(new_ref["velocity"])
    got_p, got_v = leaves(got_params), leaves(got_velocity)
    n_frozen = n_moved = 0
    worst = 0.0
    for (path, old), ref, ref_v, got, vel in zip(flat, new_p, new_v, got_p,
                                                 got_v):
        name = jax.tree_util.keystr(path)
        if jt._is_frozen(path, jcfg.freeze_at):
            n_frozen += 1
            assert got.tobytes() == np.asarray(old).tobytes(), name
            assert not vel.any(), name
            continue
        # the velocity g + wd·p, then the step p − lr·v, whose f32 result
        # may sit one ulp of p either side
        ref_v = np.asarray(ref_v, np.float64)
        scale = np.abs(ref_v).max()
        assert scale > 0, name
        n_moved += 1
        err = np.abs(vel - ref_v).max() / scale
        worst = max(worst, err)
        assert err <= STEP_TOL, (name, err)
        d_ref = np.asarray(ref, np.float64) - old
        d_got = got.astype(np.float64) - old
        ulp = np.spacing(np.abs(old).astype(np.float32)).astype(np.float64)
        assert (np.abs(d_got - d_ref)
                <= STEP_TOL * np.abs(d_ref).max() + ulp).all(), name
    assert n_frozen > 0 and n_moved > 0
    return worst


def test_fast_profile_losses_and_one_step_match_jax():
    """64 px, fixed 2x2 sampling (K1's plain version forward, K5's plain
    version backward), the sweep NMS."""
    jcfg, tcfg = fast_cfgs()
    assert tcfg.pooler_sampling_ratio == 2 and tcfg.fast_nms
    check_step(jcfg, tcfg, 64)


def _losses(cfg, params, batch, draws):
    return tt.compute_losses(params, torch_batch(batch), draws, cfg, 64)


@pytest.fixture(scope="module")
def knob_inputs():
    jcfg, tcfg = fast_cfgs()
    tree = narrow_tree(jcfg)
    batch = make_batch(64, B=4, seed=5)
    draws = jax_draws(jax.random.PRNGKey(11), tcfg, 64, 4, 4)
    return tcfg, from_jax_train_params(tree), batch, draws


def _grads(cfg, params, batch, draws):
    state = tt.init_train_state(params, cfg, device="cpu")
    ps = [p for p in jax.tree_util.tree_leaves(
        state["params"], is_leaf=torch.is_tensor) if p.requires_grad]
    losses = _losses(cfg, state["params"], batch, draws)
    return losses, torch.autograd.grad(losses["total"], ps)


@pytest.mark.parametrize("knob", [{"train_head_chunks": 2},
                                  {"train_remat": True}])
def test_chunks_and_remat_regroup_the_same_arithmetic(knob_inputs, knob):
    """``train_head_chunks=2`` (the mask branch over two image groups) and
    ``train_remat`` (activation checkpointing) give the losses and the
    gradient of the plain step."""
    cfg, params, batch, draws = knob_inputs
    ref_l, ref_g = _grads(cfg, params, batch, draws)
    got_l, got_g = _grads(replace(cfg, **knob), params, batch, draws)
    for k in ref_l:
        np.testing.assert_allclose(float(got_l[k].detach()),
                                   float(ref_l[k].detach()), rtol=1e-6,
                                   err_msg=k)
    for a, b in zip(got_g, ref_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


def test_mask_roi_cap_equals_the_exact_cap_under_it(knob_inputs,
                                                    monkeypatch):
    """With fewer positives than ``train_mask_rois``, the capped mask
    budget selects the same ROIs as the exact one (0: T·0.25 = 16) and
    every loss is the same. One 8 px box an image keeps the positives
    few."""
    cfg, params, _, draws = knob_inputs
    cfg = replace(cfg, roi_batch_per_image=64)
    batch = make_batch(64, B=4, seed=5)
    batch["gt_valid"][:, 1:] = False
    batch["gt_boxes"][:, 0, 2:] = batch["gt_boxes"][:, 0, :2] + 8
    draws = jax_draws(jax.random.PRNGKey(11), cfg, 64, 4, 4)
    state = tt.init_train_state(params, cfg, device="cpu")
    picks = []
    gather = tt.gather_topk_mask

    def spy(mask, u, k):
        picks.append((k, int(mask.sum(-1).max())))
        return gather(mask, u, k)

    monkeypatch.setattr(tt, "gather_topk_mask", spy)
    with torch.no_grad():
        exact = _losses(replace(cfg, train_mask_rois=0), state["params"],
                        batch, draws)
        capped = _losses(replace(cfg, train_mask_rois=8), state["params"],
                         batch, draws)
    for k in exact:
        np.testing.assert_allclose(float(capped[k]), float(exact[k]),
                                   rtol=1e-6, err_msg=k)
    # the mask picks (the last of each step): the budget, and the most
    # positives an image had
    assert [picks[1][0], picks[3][0]] == [16, 8]
    assert 0 < picks[3][1] <= 8, picks
