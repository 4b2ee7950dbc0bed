"""Dry run of the data-parallel paths: n ranks against one.

Counterpart of the reference's ``__graft_entry__.dryrun_multichip``, with
its settings and its checks:

* one data-parallel training step (the batch split over the ranks, the
  parameters replicated, the gradients summed);
* **equivalence**: the same global batch through one rank gives the same
  losses, within ``1e-4 + 1e-3·|ref|`` (float32, TF32 off: only the
  summation order differs);
* **scaling**: each rank's step FLOPs (``torch.utils.flop_counter``) are
  at most ``1.35/n`` of the one-rank step's (the ranks share the compute,
  they do not repeat it);
* the sharded ``TileInferenceEngine`` (one replica a rank's device)
  answers as the one-device engine: valid flags exact, boxes rtol 1e-2,
  atol 0.5.

:func:`run_steps` is the harness: a few steps of a case, in this process
(one rank) or on a rank of :func:`..mesh.launch` (:func:`step_rank`, the
ranks' entry function).
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from dataclasses import replace

import numpy as np
import torch

from ..engine.train import init_train_state, leaves, make_train_step, \
    tree_map
from ..models import fast_profile, init_params
from ..pipeline.training import to_device
from ..utils.device import resolve_device
from ..utils.weights import fold_train_params, from_jax_train_params
from .mesh import default_backend, launch, rank_device, replicate, \
    shard_batch

LOSS_KEYS = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
             "loss_mask", "total")


@contextlib.contextmanager
def no_tf32():
    """Full float32 convs and matmuls (cuDNN picks its algorithm by batch
    size, and TF32 would show that choice as loss drift)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def dryrun_batch(B: int, S: int, seed: int = 0) -> dict:
    """The reference dry run's batch: random tiles, one valid 32 px GT box
    of class 0 an image (three padding rows), full-tile masks."""
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 255, (B, S, S, 3), np.uint8),
            "gt_boxes": np.tile(np.array([[[8., 8., 40., 40.]]],
                                         np.float32), (B, 4, 1)),
            "gt_classes": np.zeros((B, 4), np.int32),
            "gt_valid": np.tile(np.array([[True, False, False, False]]),
                                (B, 1)),
            "gt_masks": np.ones((B, 4, S, S), np.uint8)}


def params_sha256(params) -> str:
    """A digest of every parameter's bytes, in the tree's order."""
    h = hashlib.sha256()
    for _, t in leaves(params):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_steps(case: dict, group=None, device="cuda"):
    """``case["steps"]`` training steps of a case, on this rank's share of
    its global batch. The case: ``cfg``, ``image_size``, ``batch`` (the
    global batch, numpy), ``params`` (``from_jax_train_params``'s tree)
    or ``init_seed`` (``init_params`` of that seed), optional ``draws``
    (the global draws of each step; default: the step's generator),
    ``seed`` (the sampling seed, 0), ``count_flops``, ``return_state``.
    Returns (result, train state): per step the loss dict (the global
    batch's) and, with ``count_flops``, this rank's FLOPs; the digest of
    the final parameters; with ``return_state`` the final parameters and
    velocity as numpy trees. Without a group it runs on ``device``, and
    raises without a card unless it is given ``device="cpu"``."""
    cfg, S = case["cfg"], case["image_size"]
    dev = group.device if group is not None else resolve_device(device)
    params = case.get("params")
    if params is None:
        params = from_jax_train_params(init_params(
            cfg, torch.Generator().manual_seed(case["init_seed"])))
    state = init_train_state(params, cfg, seed=case.get("seed", 0),
                             device=dev)
    batch = case["batch"]
    if group is not None:
        replicate(state["params"], group)
        batch = shard_batch(batch, group.rank, group.world)
    batch = to_device(batch, dev)
    step = make_train_step(cfg, S, group)
    out = {"metrics": [], "flops": [], "seconds": []}
    with no_tf32():
        for i in range(case.get("steps", 1)):
            draws = case["draws"][i] if case.get("draws") else None
            if draws is not None:
                draws = {k: torch.as_tensor(v).to(dev)
                         for k, v in draws.items()}
            t0 = time.perf_counter()
            if case.get("count_flops"):
                from torch.utils.flop_counter import FlopCounterMode

                with FlopCounterMode(display=False) as fc:
                    m = step(state, batch, draws)
                out["flops"].append(int(fc.get_total_flops()))
            else:
                m = step(state, batch, draws)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["seconds"].append(time.perf_counter() - t0)
    out["params_sha256"] = params_sha256(state["params"])
    if case.get("return_state"):
        for k in ("params", "velocity"):
            out[k] = tree_map(lambda _, t: t.detach().cpu().numpy(),
                              state[k])
    return out, state


def step_rank(group, cases: list) -> list:
    """A rank's entry function (:func:`..mesh.launch`): every case's
    :func:`run_steps` on this rank."""
    return [run_steps(case, group)[0] for case in cases]


def compare_ranks(cases: list, n: int, device="cuda",
                  backend: str | None = None) -> tuple:
    """Each case on one rank in this process and on ``n`` launched ranks:
    (one-rank results, one-rank states, [rank results] a case, the ranks'
    kernel launch counts)."""
    one, states = [], []
    for case in cases:
        res, state = run_steps(case, None, rank_device(device, 0))
        one.append(res)
        states.append(state)
    ranks = launch(step_rank, n, cases, device=device, backend=backend)
    per_case = [[r["result"][i] for r in ranks] for i in range(len(cases))]
    return one, states, per_case, [r["launches"] for r in ranks]


def check_losses(got: dict, ref: dict, what: str) -> None:
    """``|got − ref| ≤ 1e-4 + 1e-3·|ref|`` for every loss."""
    for k in LOSS_KEYS:
        v, r = got[k], ref[k]
        if not abs(v - r) <= 1e-4 + 1e-3 * abs(r):
            raise AssertionError(f"loss {k!r} diverges ({what}): {r} vs {v}")


def dryrun_multigpu(n_devices: int, device="cuda",
                    backend: str | None = None) -> dict:
    """The reference's multi-chip dry run on ``n_devices`` ranks (see the
    module docstring); raises on a failed check, prints the reference's
    dicts and returns them merged."""
    backend = backend or default_backend(device)
    cfg = replace(fast_profile(post_nms_topk=64), roi_batch_per_image=64,
                  rpn_batch_per_image=32, detections_per_image=8,
                  compute_dtype="float32")
    B, S = n_devices, 64
    case = {"cfg": cfg, "image_size": S, "batch": dryrun_batch(B, S),
            "init_seed": 0, "count_flops": True}
    (ref,), (state1,), (ranks,), _ = compare_ranks([case], n_devices,
                                                   device, backend)
    m_n, m_1 = ranks[0]["metrics"][0], ref["metrics"][0]
    out = {"n_dev_losses": m_n}
    print(out)
    print({"one_dev_losses": m_1})
    check_losses(m_n, m_1, f"1 and {n_devices} ranks")
    if len({r["params_sha256"] for r in ranks}) != 1:
        raise AssertionError("the ranks' parameters differ after the step")
    ratio = ranks[0]["flops"][0] / ref["flops"][0]
    flops = {"per_device_flops_ratio": round(ratio, 4),
             "ideal": round(1.0 / n_devices, 4)}
    print(flops)
    if ratio > 1.35 / n_devices:
        raise AssertionError(
            f"the data-parallel step does not share its compute: a rank's "
            f"FLOPs are {ratio:.3f} of the one-rank step's (ideal "
            f"{1 / n_devices:.3f})")

    # the sharded engine (the make_detections engine) against one device
    from ..engine.infer import TileInferenceEngine

    icfg = replace(cfg, min_size_test=S, max_size_test=S)
    params = fold_train_params(state1["params"])
    devices = [rank_device(device, r) for r in range(n_devices)]
    tiles = np.random.default_rng(1).integers(
        0, 255, (3 * n_devices, S, S, 3), np.uint8)

    def feed():
        yield tiles[:2 * n_devices]
        yield tiles[2 * n_devices:]          # the tail batch is padded

    def detect(devs):
        eng = TileInferenceEngine(params, icfg, batch_size=2 * n_devices,
                                  devices=devs, mask_format="u8")
        t0 = time.perf_counter()
        with no_tf32():
            res = list(eng.run(feed()))
        return eng, res, time.perf_counter() - t0

    eng, outs, dt_n = detect(devices)
    _, outs1, dt_1 = detect(devices[:1])
    if len(eng.replicas) != n_devices:
        raise AssertionError(f"the engine holds {len(eng.replicas)} "
                             f"replicas, not {n_devices}")
    n_det = sum(int(o["valid"].sum()) for o in outs)
    n_det1 = sum(int(o["valid"].sum()) for o in outs1)
    if n_det != n_det1:
        raise AssertionError(f"sharded inference changes detections: "
                             f"{n_det} vs {n_det1}")
    for o_n, o_1 in zip(outs, outs1):
        np.testing.assert_array_equal(o_n["valid"], o_1["valid"])
        np.testing.assert_allclose(o_n["boxes"][o_n["valid"]],
                                   o_1["boxes"][o_1["valid"]],
                                   rtol=1e-2, atol=0.5)
    infer = {"inference_tiles": eng.tiles_seen,
             "inference_detections": n_det, "mesh_devices": n_devices,
             "equivalent_to_single_device": True,
             "n_dev_vs_1_dev_speedup": round(dt_1 / dt_n, 3) if dt_n else 0,
             "devices": [str(d) for d in devices], "backend": backend}
    print(infer)
    return {**out, "one_dev_losses": m_1, **flops, **infer}
