"""The training entry point of the port over two gloo ranks on the CPU:
``python -m roadsurf_tpu_torch.pipeline.training <config> --device cpu
--n-devices 2``. One checkpoint and one ``metrics.jsonl`` line a step
(rank 0 alone writes them); the first step's losses equal to the
one-process step on the loader's first batch (each rank's batch is its
rows of it), rtol 1e-5, atol 1e-6; and a resumed run restarts both ranks
at the checkpoint's step.

The second step's losses are not compared with a one-process run: a
1e-7 relative change of the parameters (such as the ranks' other
summation order of the gradients) moves them by up to 1.2% on this
random-init model, whose top-k and matching decide between near-equal
scores.
"""

import json
import os

import numpy as np
import torch

from roadsurf_tpu_torch.engine.train import init_train_state, leaves, \
    train_step
from roadsurf_tpu_torch.models import from_detectron2_yaml, init_params
from roadsurf_tpu_torch.pipeline import training
from roadsurf_tpu_torch.utils.weights import from_jax_train_params
from test_torch_train_data import _mini_coco

torch.set_num_threads(1)

LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
          "loss_mask", "total", "lr")


def _config(tmp_path, coco, img_dir, name):
    """A ``train_model.py`` block over the mini tileset: the narrow FPN and
    heads on 64 px tiles, IMS_PER_BATCH 2."""
    wd = tmp_path / name
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
    config = tmp_path / f"{name}.yaml"
    config.write_text(
        "train_model.py:\n"
        f"  working_directory: {wd}\n"
        "  COCO_files: {trn: COCO_trn.json}\n"
        "  detectron2_config_file: d2.yaml\n"
        "  image_size: 64\n")
    return str(config), wd / "logs"


def _written(log_dir, runs: int) -> list:
    """The log dir's files but TensorBoard's, of which there are none (no
    TensorBoard installed) or one a run (rank 0's)."""
    files = sorted(os.listdir(log_dir))
    events = [f for f in files if f.startswith("events.out.tfevents")]
    assert len(events) in (0, runs), events
    return [f for f in files if f not in events]


def _lines(log_dir):
    with open(log_dir / "metrics.jsonl") as f:
        return [json.loads(ln) for ln in f]


def test_entry_point_trains_two_ranks_and_resumes(tmp_path):
    coco, img_dir = _mini_coco(tmp_path, n_images=3, S=64)
    args = ["--device", "cpu", "--log-every", "1"]
    config, logs = _config(tmp_path, coco, img_dir, "dp")
    assert training.main([config, *args, "--n-devices", "2",
                          "--max-iter", "2"]) == 0
    assert _written(logs, 1) == ["metrics.jsonl", "model_0000001.npz"]
    lines = _lines(logs)
    assert [ln["iter"] for ln in lines] == [1, 2]

    # the one-process first step: the loader's first batch of the run's
    # seed, from the run's initial parameters
    cfg = from_detectron2_yaml(str(tmp_path / "dp" / "d2.yaml"))
    feeder = training.Prefetcher(training.CocoTileDataset(coco, img_dir, 16),
                                 2, seed=7)
    batch = training.to_device(feeder.next(), "cpu")
    feeder.close()
    state = init_train_state(from_jax_train_params(init_params(
        cfg, torch.Generator().manual_seed(7))), cfg, seed=7, device="cpu")
    want = train_step(cfg, 64)(state, batch)
    for k in LOSSES:
        np.testing.assert_allclose(lines[0][k], float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)

    # resume: both ranks restart from model_0000001.npz at step 2
    state = training.run(training.load_script_config(config,
                                                     "train_model.py"),
                         max_iter=3, n_devices=2, log_every=1,
                         device="cpu")
    assert state["step"] == 3
    assert _written(logs, 2) == ["metrics.jsonl", "model_0000001.npz",
                                 "model_0000002.npz"]
    assert [ln["iter"] for ln in _lines(logs)] == [1, 2, 3]
    assert all(torch.is_tensor(t) and t.device.type == "cpu"
               for _, t in leaves(state["params"]))
