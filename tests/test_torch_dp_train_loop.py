"""Data parallelism of the port around the step, on the CPU over gloo (the
entry point: ``tests/test_torch_dp_entry.py``):

* ``parallel/dryrun.py::dryrun_multigpu(2, "cpu", "gloo")``, the
  counterpart of the reference's ``dryrun_multichip``: 2-rank against
  1-rank losses within ``1e-4 + 1e-3·|ref|``, a rank's step FLOPs at most
  1.35/2 of the one-rank step's, the sharded engine's detections equal to
  one device's;
* the group's rules: contiguous shards, more CUDA ranks than devices
  refused unless gloo is asked for, a failing rank raised with its
  traceback.
"""

import numpy as np
import pytest
import torch

from roadsurf_tpu_torch.parallel import mesh
from roadsurf_tpu_torch.parallel.dryrun import dryrun_multigpu, step_rank

torch.set_num_threads(1)

LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
          "loss_mask", "total", "lr")


def test_dryrun_multigpu_on_two_cpu_ranks(capsys):
    out = dryrun_multigpu(2, "cpu", "gloo")
    assert out["per_device_flops_ratio"] <= 1.35 / 2
    assert out["equivalent_to_single_device"]
    assert out["inference_tiles"] == 6 and out["inference_detections"] > 0
    for k in LOSSES:
        ref = out["one_dev_losses"][k]
        assert abs(out["n_dev_losses"][k] - ref) <= 1e-4 + 1e-3 * abs(ref)
    printed = capsys.readouterr().out
    for key in ("n_dev_losses", "one_dev_losses", "per_device_flops_ratio",
                "inference_tiles"):
        assert key in printed


def test_shard_batch_takes_contiguous_rows():
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    parts = [mesh.shard_batch(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["a"] for p in parts]),
                                  batch["a"])
    assert parts[1]["b"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, 0, 4)


def test_cuda_ranks_beyond_the_devices_need_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh.check_world(2, "cuda", "nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh.launch(step_rank, 2, [], device="cuda")
    mesh.check_world(2, "cuda", "gloo")
    mesh.check_world(1, "cuda", "nccl")
    assert mesh.default_backend("cuda") == "nccl"
    assert mesh.default_backend("cpu") == "gloo"
    assert [str(mesh.rank_device("cuda", r)) for r in range(3)] == \
        ["cuda:0"] * 3
    assert mesh.default_world("cuda") == 1 and mesh.default_world("cpu") == 1


def test_a_failing_rank_is_raised_with_its_traceback():
    with pytest.raises(RuntimeError, match="KeyError: 'cfg'"):
        mesh.launch(step_rank, 2, [{}], device="cpu")
