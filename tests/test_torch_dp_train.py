"""The port's data-parallel training step on the CPU: two gloo ranks
(``parallel.mesh.launch``; ``engine/train.py`` with a group) on the same
parameters, global batch and sampling draws as

* the reference's ``jitted_train_step(cfg, S, mesh)`` on a 2-device CPU
  mesh (jit's gradient psum over the global batch): the fast profile at
  64 px with a global batch of 2, and the YAML profile at 128 px (narrow,
  the budgets of ``tests/test_torch_train_step_yaml.py``) with 4;
* the port's own one-rank step, on those and on a batch whose images give
  the two ranks different numbers of valid mask ROIs, so that averaging
  the ranks' own means would miss the global mask loss.

Tolerances are those of ``tests/test_torch_train_step.py``: losses rtol
1e-5 (atol 1e-6); velocity 1e-4·max|v| a leaf; parameters that plus one
ulp; frozen leaves bit for bit. The two ranks' parameters are bitwise
equal after the step (their digests).

The YAML case against the reference takes ``make_batch(128, B=4,
seed=6)``. On seeds 3, 4 and 5 the two packages' ONE-device steps already
differ beyond that file's velocity bound (up to 5.8e-4·max|v|, on res3's
leaves, with the losses within 2.2e-7): every loss term's gradient
differs there, and one image alone reproduces it, which points at the
backbone's backward, consistent with a ReLU input within float32 noise
of its kink that the two packages' conv sums put on either side. Seed 4
stays in the port's two-rank against one-rank check (``yaml_b4_seed4``),
where both sides sum the same way.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from roadsurf_tpu.engine import train as jt
from roadsurf_tpu.models.config import from_detectron2_yaml as j_from_yaml
from roadsurf_tpu_torch.engine import train as tt
from roadsurf_tpu_torch.models.config import from_detectron2_yaml
from roadsurf_tpu_torch.parallel.dryrun import compare_ranks
from roadsurf_tpu_torch.utils.weights import from_jax_train_params, \
    to_jax_params
from test_torch_port_model import narrow_tree
from test_torch_train_step import NARROW, SEED, compare_step, fast_cfgs, \
    jax_draws, make_batch, step_key, torch_batch

torch.set_num_threads(1)

YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "detectron2_config_3bands.yaml")


def _yaml_cfgs(S: int = 128):
    knobs = dict(NARROW, min_size_test=S, max_size_test=S,
                 rpn_pre_nms_topk_train=300, rpn_post_nms_topk_train=100,
                 roi_batch_per_image=64, rpn_batch_per_image=32)
    return replace(j_from_yaml(YAML), **knobs), \
        replace(from_detectron2_yaml(YAML), **knobs)


def _unequal_batch():
    """Image 0: its two boxes of ``make_batch``; image 1: one 10 px box, so
    the ranks sample different numbers of positive (mask) ROIs."""
    batch = make_batch(64, B=2, seed=11)
    batch["gt_valid"][1] = [True, False, False, False]
    batch["gt_boxes"][1, 0] = (20.0, 24.0, 30.0, 34.0)
    batch["gt_masks"][1] = 0
    batch["gt_masks"][1, 0, 24:34, 20:30] = 1
    return batch


@pytest.fixture(scope="module")
def runs():
    """Every case on one rank here and on two gloo ranks, in one launch."""
    jf, tf = fast_cfgs()
    jy, ty = _yaml_cfgs()
    tree_f, tree_y = narrow_tree(jf), narrow_tree(jy)
    cases = {"fast_b2": (jf, tf, tree_f, make_batch(64, B=2), 64),
             "yaml_b4": (jy, ty, tree_y, make_batch(128, B=4, seed=6), 128),
             "yaml_b4_seed4": (jy, ty, tree_y, make_batch(128, B=4, seed=4),
                               128),
             "unequal_masks": (jf, tf, tree_f, _unequal_batch(), 64)}
    port = []
    for jcfg, tcfg, tree, batch, S in cases.values():
        B, G = batch["gt_boxes"].shape[:2]
        port.append({"cfg": tcfg, "image_size": S, "batch": batch,
                     "params": from_jax_train_params(tree),
                     "draws": [jax_draws(step_key(0), tcfg, S, B, G)],
                     "seed": SEED, "return_state": True})
    one, _, ranks, _ = compare_ranks(port, 2, device="cpu", backend="gloo")
    return {name: (case, one[i], ranks[i])
            for i, (name, case) in enumerate(cases.items())}


def _jax_tree(tree):
    """A numpy tree of the port's layout -> the reference's schema."""
    return to_jax_params(tt.tree_map(lambda _, a: torch.from_numpy(a),
                                     tree))


@pytest.mark.parametrize("name", ["fast_b2", "yaml_b4"])
def test_two_ranks_match_the_reference_mesh_step(runs, name):
    (jcfg, _, tree, batch, S), _, ranks = runs[name]
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("data",))
    ref_state = {"params": tree,
                 "velocity": jax.tree.map(np.zeros_like, tree),
                 "step": jnp.zeros((), jnp.int32),
                 "seed": jnp.asarray(SEED, jnp.int32)}
    new_ref, ref_m = jt.jitted_train_step(jcfg, S, mesh)(ref_state, batch)
    got = ranks[0]
    compare_step(jcfg, tree, new_ref, ref_m, got["metrics"][0],
                 _jax_tree(got["params"]), _jax_tree(got["velocity"]))


@pytest.mark.parametrize("name", ["fast_b2", "yaml_b4", "yaml_b4_seed4",
                                  "unequal_masks"])
def test_two_ranks_match_one_rank_and_each_other(runs, name):
    (jcfg, _, tree, _, _), one, ranks = runs[name]
    assert ranks[0]["params_sha256"] == ranks[1]["params_sha256"]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    got = ranks[0]
    compare_step(jcfg, tree, {"params": _jax_tree(one["params"]),
                              "velocity": _jax_tree(one["velocity"])},
                 one["metrics"][0], got["metrics"][0],
                 _jax_tree(got["params"]), _jax_tree(got["velocity"]))


def test_averaging_the_ranks_means_would_miss_the_mask_loss(runs):
    """Each rank's own mask loss (its numerator over its own count) from
    the port's one-rank ``compute_losses`` on its half of the batch: their
    mean is not the global mask loss, which the two-rank step gives."""
    (_, tcfg, tree, batch, S), one, ranks = runs["unequal_masks"]
    params = tt.init_train_state(from_jax_train_params(tree), tcfg,
                                 device="cpu")["params"]
    draws = jax_draws(step_key(0), tcfg, S, 2, 4)
    halves = []
    with torch.no_grad():
        for r in range(2):
            half = {k: v[r:r + 1] for k, v in batch.items()}
            halves.append(float(tt.compute_losses(
                params, torch_batch(half),
                {k: v[r:r + 1] for k, v in draws.items()}, tcfg,
                S)["loss_mask"]))
    want = one["metrics"][0]["loss_mask"]
    got = ranks[0]["metrics"][0]["loss_mask"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    averaged = (halves[0] + halves[1]) / 2
    assert abs(averaged - want) > 100 * (1e-5 * abs(want) + 1e-6), \
        (halves, want)
