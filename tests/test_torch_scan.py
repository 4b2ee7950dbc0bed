"""The port's multi-batch dispatch against the JAX package's, on the CPU:
``TileInferenceEngine(..., scan_k=k)`` (k padded batches a group, the tail
group padded with empty batches that are dropped), ``make_inference_scan_fn``
(k batches stacked on a leading axis) and ``make_train_scan_step`` (k SGD
steps in one call). On the card each is a CUDA graph (``utils/graphs.py``;
``chip_smoke.py``'s ``scan_path`` holds it bit for bit against the eager
calls); on the CPU each runs its k calls in a loop, the plain version
these tests hold to the reference.

The reference's setup (tests/test_detections.py:162-202): the fast profile
at 64 px, 4 detections, tiles of 4, 4 and 3, scan_k 1 and 3, here at the
narrow widths of the port's forward tests in float32. Tolerances: the
forward tests' (valid and classes exact, boxes 1e-4 px, scores 1e-6, mask
logits 1e-4) and the training step's (``test_torch_train_step.py``); the
port at scan_k 3 equals the port at scan_k 1, and k scanned steps equal k
single steps, exactly.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadsurf_tpu.engine import train as jt
from roadsurf_tpu.engine.infer import TileInferenceEngine as JEngine
from roadsurf_tpu.models import mask_rcnn as jm
from roadsurf_tpu_torch.engine import TileInferenceEngine
from roadsurf_tpu_torch.engine import train as tt
from roadsurf_tpu_torch.models import mask_rcnn as tm
from roadsurf_tpu_torch.utils.weights import from_jax_params, \
    from_jax_train_params, to_jax_params
from test_torch_port_model import narrow_cfg, narrow_tree
from test_torch_train_step import SEED, STEP_TOL, compare_step, fast_cfgs, \
    jax_draws, make_batch, step_key

torch.set_num_threads(1)

SIZES = (4, 4, 3)


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def _compare(got: dict, ref: dict):
    """The forward tests' tolerances, on numpy arrays."""
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert np.asarray(ref["valid"]).any()
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-4)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-6)
    np.testing.assert_allclose(got["mask_logits"], ref["mask_logits"],
                               atol=1e-4)


@pytest.fixture(scope="module")
def engine_runs():
    """Both packages' engines over tiles of 4, 4 and 3 at scan_k 1 and 3,
    and the port's sharded engine at scan_k 3."""
    cfg = replace(narrow_cfg(64), detections_per_image=4)
    tree = narrow_tree(cfg)
    state = from_jax_params(tree)
    tiles = np.random.default_rng(7).integers(0, 255, (11, 64, 64, 3),
                                              np.uint8)
    feed = [tiles[:4], tiles[4:8], tiles[8:]]
    runs = {}
    for k in (1, 3):
        eng = TileInferenceEngine(state, cfg, batch_size=4, device="cpu",
                                  scan_k=k)
        runs["port", k] = list(eng.run(iter(feed))), eng.tiles_seen
        jeng = JEngine(tree, cfg, batch_size=4, devices=jax.devices()[:1],
                       scan_k=k)
        runs["jax", k] = list(jeng.run(iter(feed))), jeng.tiles_seen
    eng = TileInferenceEngine(state, cfg, batch_size=4,
                              devices=["cpu", "cpu"], scan_k=3)
    runs["sharded", 3] = list(eng.run(iter(feed))), eng.tiles_seen
    return runs


@pytest.mark.parametrize("scan_k", [1, 3])
def test_engine_agrees_with_the_reference_engine(engine_runs, scan_k):
    got, seen = engine_runs["port", scan_k]
    ref, ref_seen = engine_runs["jax", scan_k]
    assert seen == ref_seen == 11
    assert [len(o["scores"]) for o in got] == list(SIZES)
    for g, r in zip(got, ref):
        _compare(g, r)


@pytest.mark.parametrize("label", ["port", "sharded"])
def test_scan_k_3_equals_scan_k_1_exactly(engine_runs, label):
    """The groups (the tail group of one batch and two empty ones) change
    what a dispatch holds, not what a forward computes; the sharded
    engine's groups neither."""
    got, seen = engine_runs[label, 3]
    ref, _ = engine_runs["port", 1]
    assert seen == 11 and len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("scan_k", [2, 1])
def test_a_group_takes_tiles_of_one_size(scan_k):
    """A group's batches share one tile size; at scan_k 1 each batch is a
    group of its own, so the next may bring another size."""
    cfg = replace(narrow_cfg(64), detections_per_image=4)
    state = from_jax_params(narrow_tree(cfg))
    eng = TileInferenceEngine(state, cfg, batch_size=2, device="cpu",
                              scan_k=scan_k)
    rng = np.random.default_rng(3)
    feed = [rng.integers(0, 255, (2, 64, 64, 3), np.uint8),
            rng.integers(0, 255, (2, 32, 32, 3), np.uint8)]
    if scan_k > 1:
        with pytest.raises(ValueError, match="in a group of"):
            list(eng.run(iter(feed)))
        return
    outs = list(eng.run(iter(feed)))
    assert len(outs) == len(feed) and eng.tiles_seen == 4
    for got, images in zip(outs, feed):
        ref = tm.forward_inference(state, images, cfg, device="cpu")
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert got[k].dtype == v.numpy().dtype, k
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_scan_fn_matches_the_reference_and_the_forwards():
    """``make_inference_scan_fn`` at k=2 against the reference's (its
    ``lax.map``, jitted) and against two calls of ``forward_prepared``."""
    cfg = replace(narrow_cfg(64), detections_per_image=4)
    tree = narrow_tree(cfg)
    state = from_jax_params(tree)
    images = np.random.default_rng(5).integers(0, 255, (2, 3, 64, 64, 3),
                                               np.uint8)
    fn = tm.make_inference_scan_fn(cfg)
    assert fn is tm.make_inference_scan_fn(cfg)
    got = fn(state, images)
    assert got["boxes"].shape == (2, 3, 4, 4)
    ref = jax.jit(jm.make_inference_scan_fn(cfg))(tree, jnp.asarray(images))
    _compare({k: v.numpy() for k, v in got.items()},
             {k: np.asarray(v) for k, v in ref.items()})
    for i in range(2):
        one = tm.forward_prepared(state, torch.from_numpy(images[i]), cfg,
                                  True, "logits")
        for k, v in one.items():
            assert torch.equal(got[k][i], v), k


def _jax_scan(jcfg, tree, batch_list, S: int, k: int):
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *batch_list)
    state = {"params": tree, "velocity": jax.tree.map(np.zeros_like, tree),
             "step": jnp.zeros((), jnp.int32),
             "seed": jnp.asarray(SEED, jnp.int32)}
    return jax.jit(jt.make_train_scan_step(jcfg, S, k))(state, stacked)


def test_train_scan_matches_the_reference_and_single_steps():
    """Two steps in one call (fast profile, 64 px), from one state with
    the reference's draws: against the reference's ``lax.scan`` of two
    steps within the step test's tolerances (the last step's losses rtol
    1e-5; each leaf's velocity and move within STEP_TOL a step, k·STEP_TOL
    after k: v_k = m·v_(k-1) + g_k + wd·p_(k-1) carries step 1's error
    into step 2's, whose gradient is taken at parameters one step of
    rounding apart; measured, up to 1.87e-4, on leaves of the mask head
    and of res3 to res5), and equal to two single steps bit for bit (the scan's learning
    rate is a tensor, the single step's a number)."""
    jcfg, tcfg = fast_cfgs()
    S, B, k = 64, 2, 2
    tree = narrow_tree(jcfg)
    batch_list = [make_batch(S, B, seed=3 + i) for i in range(k)]
    G = batch_list[0]["gt_boxes"].shape[1]
    draws = [jax_draws(step_key(i), tcfg, S, B, G) for i in range(k)]
    new_ref, ref_m = _jax_scan(jcfg, tree, batch_list, S, k)

    def fresh():
        return tt.init_train_state(from_jax_train_params(tree), tcfg,
                                   seed=SEED, device="cpu")

    scan = tt.make_train_scan_step(tcfg, S, k, device="cpu")
    state = fresh()
    got_m = scan(state, {n: np.stack([b[n] for b in batch_list])
                         for n in batch_list[0]},
                 {n: torch.stack([d[n] for d in draws]) for n in draws[0]})
    assert state["step"] == k
    compare_step(jcfg, tree, new_ref, ref_m, got_m,
                 to_jax_params(state["params"]),
                 to_jax_params(state["velocity"]), step_tol=k * STEP_TOL)

    single = fresh()
    step = tt.train_step(tcfg, S)
    for b, d in zip(batch_list, draws):
        one_m = step(single, {n: torch.from_numpy(np.ascontiguousarray(v))
                              for n, v in b.items()}, d)
    assert single["step"] == k
    for n, v in one_m.items():
        assert torch.equal(got_m[n], v), n
    for tree_name in ("params", "velocity"):
        for (path, a), (_, b) in zip(tt.leaves(state[tree_name]),
                                     tt.leaves(single[tree_name])):
            assert torch.equal(a, b), (tree_name, path)


def test_train_scan_draws_what_single_steps_draw():
    """Without ``draws`` the scan takes each step's uniforms from
    ``step_generator`` (seed, step), as the single step does: k scanned
    steps consume exactly what k single steps would."""
    _, tcfg = fast_cfgs()
    S, B, k = 64, 2, 2
    tree = narrow_tree(fast_cfgs()[0])
    batch_list = [make_batch(S, B, seed=8 + i) for i in range(k)]
    states = [tt.init_train_state(from_jax_train_params(tree), tcfg,
                                  seed=SEED, device="cpu") for _ in range(2)]
    scan_m = tt.make_train_scan_step(tcfg, S, k, device="cpu")(
        states[0], {n: np.stack([b[n] for b in batch_list])
                    for n in batch_list[0]})
    step = tt.train_step(tcfg, S)
    for b in batch_list:
        one_m = step(states[1], {n: torch.from_numpy(np.ascontiguousarray(v))
                                 for n, v in b.items()})
    for n, v in one_m.items():
        assert torch.equal(scan_m[n], v), n
    for (_, a), (_, b) in zip(tt.leaves(states[0]["params"]),
                              tt.leaves(states[1]["params"])):
        assert torch.equal(a, b)


def test_train_scan_takes_one_device_and_k_batches():
    _, tcfg = fast_cfgs()
    with pytest.raises(ValueError, match="one device"):
        tt.make_train_scan_step(tcfg, 64, 2, group=object(), device="cpu")
    scan = tt.make_train_scan_step(tcfg, 64, 3, device="cpu")
    batch = make_batch(64)
    with pytest.raises(ValueError, match="2 batches for a scan of 3"):
        scan({}, {n: np.stack([v, v]) for n, v in batch.items()})


def test_forward_features_match_the_reference():
    """The reference's ``forward_features`` (backbone and FPN of
    preprocessed images) in float32: the P-levels in its NHWC layout."""
    cfg = narrow_cfg(64)
    tree = narrow_tree(cfg)
    state = from_jax_params(tree)
    x = np.random.default_rng(2).normal(0, 50, (2, 64, 64, 3)) \
        .astype(np.float32)
    got = tm.forward_features(state, torch.from_numpy(x), cfg,
                              torch.float32)
    ref = jm.forward_features(tree, jnp.asarray(x), cfg, jnp.float32)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5 * scale)
