"""``roadsurf_tpu_torch/entry.py`` against the reference's
``__graft_entry__.py``, on the CPU.

* ``entry``'s config and the images' shape and dtype are the
  reference's (its ``init_params`` a recorder); the port's images are
  seeded, the same on every call;
* ``fn`` is the port's fast forward: at a narrow width (the module's
  ``fast_profile`` and ``init_params`` replaced by a narrow float32 config
  and the JAX package's narrow tree), ``fn`` on ``entry(device="cpu")``'s
  own arguments equals ``forward_prepared`` bit for bit, and the
  reference's ``fn`` on the same weights and tiles within the forward's
  tolerances (``tests/test_torch_port_model.py``: valid and classes exact,
  boxes 1e-4 px, scores 1e-6, mask logits 1e-4);
* ``dryrun_multigpu``, the counterpart of ``dryrun_multichip``, stands
  beside it;
* without a card ``entry()`` raises.
"""

from __future__ import annotations

import importlib.util
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import roadsurf_tpu.models as j_models
from roadsurf_tpu_torch import entry as port_entry
from roadsurf_tpu_torch.models.config import fast_profile
from roadsurf_tpu_torch.models.mask_rcnn import forward_prepared
from roadsurf_tpu_torch.parallel import dryrun
from test_torch_measure_stages import same_cfg
from test_torch_port_model import _compare, narrow_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NARROW = {"fpn_channels": 32, "box_fc_dim": 64, "mask_conv_dim": 32,
          "min_size_test": 64, "max_size_test": 64,
          "compute_dtype": "float32"}


def reference_entry():
    spec = importlib.util.spec_from_file_location("reference_graft_entry",
                                                  ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _narrow(monkeypatch) -> tuple:
    """The port's entry at a narrow width; (JAX config, JAX tree)."""
    jcfg = replace(j_models.fast_profile(), **NARROW)
    tree = narrow_tree(jcfg)
    monkeypatch.setattr(port_entry, "fast_profile",
                        lambda: replace(fast_profile(), **NARROW))
    monkeypatch.setattr(port_entry, "init_params", lambda cfg, g: tree)
    return jcfg, tree


def test_the_config_and_images_are_the_references(monkeypatch):
    seen = {}

    def ref_init(key, cfg):
        seen["ref"] = cfg
        return {}

    monkeypatch.setattr(j_models, "init_params", ref_init)
    _, (_, ref_images) = reference_entry().entry()
    tree = narrow_tree(replace(j_models.fast_profile(), **NARROW))

    def port_init(cfg, generator):
        seen["port"] = cfg
        seen["seed"] = generator.initial_seed()
        return tree

    monkeypatch.setattr(port_entry, "init_params", port_init)
    _, (state, images) = port_entry.entry(device="cpu")
    same_cfg(seen["port"], seen["ref"])
    assert seen["seed"] == 0
    assert (images.shape, images.dtype) == (ref_images.shape,
                                            ref_images.dtype)
    assert images.min() >= 0 and images.max() <= 254
    _, (_, again) = port_entry.entry(device="cpu")
    np.testing.assert_array_equal(images, again)
    assert state["backbone"]["stem"]["w"].dtype == torch.bfloat16


def test_fn_is_the_fast_forward_on_its_own_arguments(monkeypatch):
    jcfg, tree = _narrow(monkeypatch)
    fn, (state, images) = port_entry.entry(device="cpu")
    got = fn(state, images)
    with torch.inference_mode():
        want = forward_prepared(state, torch.from_numpy(images),
                                port_entry.fast_profile(), True, "logits")
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ref = jax.jit(j_models.make_inference_fn(jcfg))(tree,
                                                    jnp.asarray(images))
    _compare(got, ref)


def test_the_dry_run_stands_beside_it_and_a_card_is_needed(monkeypatch):
    assert port_entry.dryrun_multigpu is dryrun.dryrun_multigpu
    assert set(port_entry.__all__) == {"entry", "dryrun_multigpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_entry, "init_params", lambda *a: pytest.fail(
        "weights made without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
