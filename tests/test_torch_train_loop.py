"""The training loop of the PyTorch port on the CPU (``pipeline/
training.py``): ``train`` for two steps on a mini COCO tileset with its
checkpoint, its eval and ``metrics.jsonl`` under the reference's keys; the
``.npz`` checkpoints in both directions (the port's loads in the JAX
package's ``load_params`` as a tree of its schema, and a checkpoint the
reference wrote resumes in the port at its step); and the entry point
``python -m roadsurf_tpu_torch.pipeline.training`` with ``--device cpu``.

The model is the port's ``init_params`` (ResNet-50 at full width) with a
narrow FPN and heads, on 64 px tiles, in float32.
"""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from roadsurf_tpu.models.config import fast_profile as j_fast
from roadsurf_tpu.models.mask_rcnn import init_params as j_init_params
from roadsurf_tpu.utils.checkpoint import load_params as j_load_params
from roadsurf_tpu.utils.checkpoint import save_params as j_save_params
from roadsurf_tpu_torch.models import fast_profile, init_params
from roadsurf_tpu_torch.pipeline import training
from roadsurf_tpu_torch.utils.weights import _flatten, to_jax_params
from test_torch_train_data import _mini_coco

torch.set_num_threads(1)

KNOBS = {"fpn_channels": 32, "box_fc_dim": 64, "mask_conv_dim": 32,
         "compute_dtype": "float32", "min_size_test": 64,
         "max_size_test": 64, "roi_batch_per_image": 32,
         "rpn_batch_per_image": 16, "rpn_post_nms_topk_train": 64,
         "detections_per_image": 8}
TRAIN_KEYS = {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
              "loss_mask", "total", "lr", "imgs_per_sec", "iter"}


def _cfgs(**kw):
    return (replace(j_fast(post_nms_topk=16), **KNOBS, **kw),
            replace(fast_profile(post_nms_topk=16), **KNOBS, **kw))


def _schema(tree) -> dict:
    return {k: tuple(np.shape(v)) for k, v in _flatten(tree).items()}


@pytest.fixture(scope="module")
def tileset(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiles")
    trn = _mini_coco(d, n_images=3, S=64)
    (d / "val").mkdir()
    val = _mini_coco(d / "val", n_images=2, S=64)
    return trn, val


def test_train_writes_checkpoints_metrics_and_evals(tileset, tmp_path):
    (coco, img_dir), (vcoco, vimg) = tileset
    jcfg, cfg = _cfgs(checkpoint_period=2, eval_period=2)
    log_dir = str(tmp_path / "logs")
    state = training.train(cfg, coco, img_dir, log_dir, val_coco=vcoco,
                           val_images=vimg, max_iter=2, batch_size=2,
                           image_size=64, max_instances=6, log_every=1,
                           device="cpu")
    assert state["step"] == 2
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    train_lines = [ln for ln in lines if "total" in ln]
    assert [ln["iter"] for ln in train_lines] == [1, 2]
    assert all(set(ln) == TRAIN_KEYS for ln in train_lines)
    assert all(np.isfinite(ln[k]) for ln in train_lines for k in ln)
    val = [ln for ln in lines if "val_total" in ln]
    assert len(val) == 1 and val[0]["iter"] == 2
    assert {k for k in val[0] if "/" in k} == {
        f"val_{t}/{k}" for t in ("bbox", "segm") for k in ("AP", "AP50",
                                                            "AP75")}
    assert {f"val_{k}" for k in TRAIN_KEYS - {"lr", "imgs_per_sec",
                                              "iter"}} <= set(val[0])

    # the checkpoint, in the reference's reader and schema
    tree, step = j_load_params(os.path.join(log_dir, "model_0000001.npz"))
    assert step == 2
    want = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        jax.eval_shape(lambda k: j_init_params(k, jcfg),
                                       jax.random.PRNGKey(0)))
    assert _schema(tree) == _schema(want)
    for k, v in _flatten(to_jax_params(state["params"])).items():
        np.testing.assert_array_equal(_flatten(tree)[k], v)


def test_a_reference_checkpoint_resumes_at_its_step(tileset, tmp_path):
    (coco, img_dir), _ = tileset
    _, cfg = _cfgs(checkpoint_period=100)
    # values from the port's initializer, written by the reference
    tree = jax.tree.map(lambda t: t.numpy(), init_params(
        cfg, torch.Generator().manual_seed(1)))
    log_dir = str(tmp_path / "logs")
    j_save_params(os.path.join(log_dir, "model_0000002.npz"), tree, step=3)
    state = training.train(cfg, coco, img_dir, log_dir, max_iter=3,
                           batch_size=2, image_size=64, max_instances=6,
                           device="cpu")
    assert state["step"] == 3
    got = _flatten(to_jax_params(state["params"]))
    for k, v in _flatten(tree).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # and trains on from there: step 4, its checkpoint at the end
    state = training.train(cfg, coco, img_dir, log_dir, max_iter=4,
                           batch_size=2, image_size=64, max_instances=6,
                           device="cpu")
    assert state["step"] == 4
    _, step = j_load_params(os.path.join(log_dir, "model_0000003.npz"))
    assert step == 4


def test_entry_point_trains_on_the_cpu(tileset, tmp_path):
    """``main`` on a ``train_model.py`` block whose detectron2 YAML sets a
    narrow model on 64 px tiles."""
    (coco, img_dir), _ = tileset
    wd = tmp_path / "wd"
    wd.mkdir()
    os.symlink(img_dir, wd / "trn-images")
    os.symlink(coco, wd / "COCO_trn.json")
    (wd / "d2.yaml").write_text(
        "MODEL:\n"
        "  FPN: {OUT_CHANNELS: 32}\n"
        "  RPN: {BATCH_SIZE_PER_IMAGE: 16, POST_NMS_TOPK_TRAIN: 64}\n"
        "  ROI_HEADS: {BATCH_SIZE_PER_IMAGE: 32}\n"
        "  ROI_BOX_HEAD: {FC_DIM: 64, POOLER_SAMPLING_RATIO: 2}\n"
        "  ROI_MASK_HEAD: {CONV_DIM: 32}\n"
        "INPUT: {MIN_SIZE_TRAIN: [64], MIN_SIZE_TEST: 64}\n"
        "SOLVER: {IMS_PER_BATCH: 2, MAX_ITER: 12000}\n")
    config = tmp_path / "config.yaml"
    config.write_text(
        "train_model.py:\n"
        f"  working_directory: {wd}\n"
        "  log_subfolder: logs\n"
        "  COCO_files: {trn: COCO_trn.json}\n"
        "  detectron2_config_file: d2.yaml\n"
        "  image_size: 64\n"
        "  model_weights: {model_zoo_checkpoint_url: absent.pkl}\n")
    assert training.main([str(config), "--device", "cpu", "--max-iter", "1",
                          "--batch-size", "2"]) == 0
    _, step = j_load_params(str(wd / "logs" / "model_0000000.npz"))
    assert step == 1
