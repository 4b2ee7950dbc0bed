"""The port's sharded inference engine on the CPU: ``TileInferenceEngine(
..., devices=["cpu", "cpu"])`` (one replica a device, each batch split
into contiguous shards, the outputs gathered in row order, the tail
batch padded and trimmed) against the one-device engine and against the
reference's engine on a 2-device CPU mesh, at a narrow width in float32,
on the fast and the parity profile. Valid flags and classes exact, boxes
1e-4 px, scores 1e-6; and ``make_detections``' device choice
(``engine_devices``, ``--n-devices``).
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from roadsurf_tpu.engine.infer import TileInferenceEngine as JEngine
from roadsurf_tpu.models.config import from_detectron2_yaml as j_from_yaml
from roadsurf_tpu_torch.engine import TileInferenceEngine
from roadsurf_tpu_torch.models.config import from_detectron2_yaml
from roadsurf_tpu_torch.pipeline import detections
from roadsurf_tpu_torch.utils.weights import from_jax_params
from test_torch_port_model import narrow_cfg, narrow_tree
from test_torch_port_rules import _detections_config

torch.set_num_threads(1)

YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "detectron2_config_3bands.yaml")


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def _parity_cfg(S: int = 128):
    knobs = dict(fpn_channels=32, box_fc_dim=64, mask_conv_dim=32,
                 compute_dtype="float32", min_size_test=S, max_size_test=S,
                 rpn_pre_nms_topk_test=200, rpn_post_nms_topk_test=100,
                 detections_per_image=20)
    return replace(from_detectron2_yaml(YAML), **knobs), \
        replace(j_from_yaml(YAML), **knobs)


def _compare(got: dict, ref: dict):
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert got["valid"].any()
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-4)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-6)


@pytest.mark.parametrize("profile", ["fast", "parity"])
def test_sharded_engine_equals_one_device_and_the_reference(profile):
    if profile == "fast":
        cfg = narrow_cfg(64)
        jcfg, side = cfg, 64
    else:
        cfg, jcfg = _parity_cfg()
        side = 64                   # tiles resized to 128 by the forward
    tree = narrow_tree(jcfg)
    state = from_jax_params(tree)
    tiles = np.random.default_rng(3).integers(0, 255, (6, side, side, 3),
                                              np.uint8)
    feed = [tiles[:4], tiles[4:]]                # a short tail batch

    def port(devices):
        eng = TileInferenceEngine(state, cfg, batch_size=4, devices=devices,
                                  mask_format="u8")
        return eng, list(eng.run(feed))

    eng, sharded = port(["cpu", "cpu"])
    assert len(eng.replicas) == 2 and eng.shard == 2
    assert eng.tiles_seen == 6
    _, one = port(["cpu"])
    ref = list(JEngine(tree, jcfg, batch_size=4, devices=jax.devices()[:2],
                       mask_format="u8").run(iter(feed)))
    assert [o["valid"].shape[0] for o in sharded] == [4, 2]
    for got, a, b in zip(sharded, one, ref):
        _compare(got, a)
        _compare(got, b)


def test_an_uneven_split_runs_on_the_first_device(caplog):
    cfg = narrow_cfg(64)
    eng = TileInferenceEngine(from_jax_params(narrow_tree(cfg)), cfg,
                              batch_size=3, devices=["cpu", "cpu"])
    assert len(eng.replicas) == 1 and eng.shard == 3
    assert "does not split" in caplog.text
    with pytest.raises(ValueError, match="one type"):
        TileInferenceEngine(from_jax_params(narrow_tree(cfg)), cfg,
                            batch_size=2, devices=["cpu", "meta"])


def test_make_detections_takes_n_devices(tmp_path, monkeypatch):
    cpu = torch.device("cpu")
    assert detections.engine_devices("cpu") == [cpu]
    assert detections.engine_devices("cpu", 2) == [cpu, cpu]
    config = _detections_config(tmp_path)
    assert detections.main([config, "--device", "cpu", "--n-devices",
                            "2"]) == 0
    assert (tmp_path / "tst_detections_at_0dot05_threshold.gpkg").exists()
    # CUDA: every visible GPU by default, never more than are visible
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert detections.engine_devices("cuda") == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]
    assert detections.engine_devices("cuda", 1) == [torch.device("cuda")]
    with pytest.raises(ValueError, match="3 devices asked for, 2 visible"):
        detections.engine_devices("cuda", 3)
