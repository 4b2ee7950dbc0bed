"""Rules of the PyTorch port that hold whatever the numbers: it imports
nothing of JAX or of the JAX package, its entry points need a card unless
the caller asks for the CPU, and the adaptive pooler is refused rather than
stood in for."""

import ast
import os

import numpy as np
import pytest
import torch

from roadsurf_tpu_torch.engine import TileInferenceEngine
from roadsurf_tpu_torch.models import fast_profile, forward_inference, \
    init_params
from roadsurf_tpu_torch.ops import roi_align as tra
from roadsurf_tpu_torch.ops.roi_align_kernel import roi_align_fused
from roadsurf_tpu_torch.utils.weights import from_jax_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    pkg = os.path.join(ROOT, "roadsurf_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    return module == "jax" or module.startswith("jax.") \
        or module == "roadsurf_tpu" or module.startswith("roadsurf_tpu.")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Static: the test process itself has jax imported (conftest), so
    sys.modules proves nothing. Relative imports stay inside the port."""
    bad = []
    files = list(_port_sources())
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                names = [node.args[0].value]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_forbidden_matches_the_package_not_the_port():
    assert _forbidden("roadsurf_tpu") and _forbidden("roadsurf_tpu.ops.nms")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("roadsurf_tpu_torch")
    assert not _forbidden("roadsurf_tpu_torch.ops")
    assert not _forbidden("jaxlib_free_module")


@pytest.fixture(scope="module")
def state_and_cfg():
    cfg = fast_profile(post_nms_topk=32)
    return from_jax_params(init_params(cfg, torch.Generator().manual_seed(0))
                           ), cfg


def test_entry_points_need_a_card_unless_asked_for_the_cpu(state_and_cfg):
    state, cfg = state_and_cfg
    imgs = np.zeros((1, 256, 256, 3), np.uint8)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward_inference(state, imgs, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TileInferenceEngine(state, cfg, batch_size=1)
    out = forward_inference(state, imgs, cfg, device="cpu")
    assert out["boxes"].device.type == "cpu"
    eng = TileInferenceEngine(state, cfg, batch_size=1, device="cpu")
    assert next(eng.run([imgs]))["boxes"].shape == (1, 8, 4)


def test_int8_configs_are_refused(state_and_cfg):
    from dataclasses import replace

    state, cfg = state_and_cfg
    for knob in ({"int8_scope": "full"}, {"int8_backbone": True},
                 {"int8_pyramid": True}):
        with pytest.raises(NotImplementedError, match="int8"):
            forward_inference(state, np.zeros((1, 256, 256, 3), np.uint8),
                              replace(cfg, **knob), device="cpu")


def test_adaptive_sampling_is_refused_before_any_device_branch(monkeypatch):
    """sampling == 0 raises on the dispatcher's path, naming the ROADMAP
    item, before the kernel wrapper (or its plain version) is reached."""
    def must_not_run(*a, **k):
        raise AssertionError("pooler reached")

    monkeypatch.setattr(tra, "roi_align_fused", must_not_run)
    monkeypatch.setattr(tra, "roi_align_fused_ref", must_not_run)
    feats = [torch.zeros((1, 64 // 2 ** i, 64 // 2 ** i, 4))
             for i in range(3)]
    boxes = torch.zeros((1, 2, 4))
    for fn in (tra.roi_align_multilevel, tra.roi_align_multilevel_ref):
        with pytest.raises(NotImplementedError,
                           match="roi_align_fused_blocked"):
            fn(feats, boxes, 7, sampling=0)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks a CUDA call goes through, exercised on meta tensors (no
    data, no device): dtype, layout and shapes are refused with an error."""
    from roadsurf_tpu_torch.ops.roi_align_kernel import _check

    B, R, C = 2, 4, 8
    feats = tuple(torch.empty((B, s, s, C), dtype=torch.bfloat16,
                              device="meta") for s in (16, 8))
    boxes = torch.empty((B, R, 4), device="meta")
    lvl = torch.empty((B, R), dtype=torch.int32, device="meta")
    _check(feats, boxes, lvl, 7, 2)
    with pytest.raises(TypeError):
        _check(tuple(f.float() for f in feats), boxes, lvl, 7, 2)
    with pytest.raises(ValueError):
        _check((feats[0].permute(0, 2, 1, 3),), boxes, lvl, 7, 2)
    with pytest.raises(ValueError):
        _check(feats, boxes, lvl.long(), 7, 2)
    with pytest.raises(ValueError):
        _check(feats, boxes[:, :, :2], lvl, 7, 2)
    with pytest.raises(ValueError):
        _check(feats, boxes, lvl, 7, 0)
    with pytest.raises(ValueError):
        _check(feats * 3, boxes, lvl, 7, 2)
    assert roi_align_fused.launches == 0
