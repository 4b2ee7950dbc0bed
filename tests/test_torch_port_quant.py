"""The static-int8 stack of the PyTorch port (``models/quant.py``, the int8
modes of the poolers, the int8 branches of the heads and the forward)
against the JAX package, on the CPU at a narrow width.

Tolerances:
* quantized weights, and ``mult``/``bias`` given the same activation
  scale: exact (the same float32 divisions and products);
* calibration scales: rtol 1e-5 (float32 forwards whose convs sum in
  another order);
* the uint8-direct stem's bias map: atol 1e-5 (a float32 conv of the
  constant image, values up to ~10);
* int8 conv units, deconv, linear and max pool: exact. Their operands are
  exact in float32, every sum here stays below 2²⁴, and the epilogue is the
  same float32 operations in the same order;
* the int8 stages (ResNet, FPN, RPN head) on the JAX quant tree: exact;
* the int8 poolers: ``tests/test_torch_port_int8_poolers.py``;
* the whole int8 forward: ``tests/test_torch_port_quant_forward.py``.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadsurf_tpu.models import quant as jq
from roadsurf_tpu.models.config import from_detectron2_yaml as j_from_yaml
from roadsurf_tpu.models.mask_rcnn import preprocess as j_preprocess
from roadsurf_tpu_torch.models import quant as tq
from roadsurf_tpu_torch.utils.weights import from_jax_params, \
    from_jax_quant
from test_torch_port_model import narrow_cfg, narrow_tree

torch.set_num_threads(1)

YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "detectron2_config_3bands.yaml")
INT8 = {"int8_scope": "full", "int8_pyramid": True}


@pytest.fixture(autouse=True)
def _no_tf32():
    """Full float32 products wherever TF32 could apply."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW channels_last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _f(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


class Setup:
    """A configuration, its narrow random tree, a calibration batch and
    the JAX package's quant tree for it (numpy)."""

    def __init__(self, cfg, native: int, seed: int = 1):
        self.cfg = cfg
        self.tree = narrow_tree(cfg)
        self.imgs = np.random.default_rng(seed).integers(
            0, 255, (2, native, native, 3), np.uint8)
        self.jquant = jax.device_get(jq.prepare_quantized(self.tree,
                                                          self.imgs, cfg))
        self.state = from_jax_params(self.tree)


@pytest.fixture(scope="module")
def fast():
    """fast_profile at 64 px (native: the uint8-direct stem), int8 full +
    pyramid."""
    return Setup(replace(narrow_cfg(64), **INT8), 64)


@pytest.fixture(scope="module")
def parity():
    """The YAML's parity profile at 112 -> 224 px, 200/100 proposals, 20
    detections, int8 full + pyramid."""
    cfg = replace(j_from_yaml(YAML), fpn_channels=32, box_fc_dim=64,
                  mask_conv_dim=32, compute_dtype="float32", min_size_test=224,
                  max_size_test=224, rpn_pre_nms_topk_test=200,
                  rpn_post_nms_topk_test=100, detections_per_image=20, **INT8)
    return Setup(cfg, 112)


# ---------------------------------------------------------------------------
# quantization and calibration

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _assert_quant_trees_match(got: dict, ref: dict):
    """wq exact; the stem_u8 bias map atol 1e-5; every scale, multiplier
    and the rest rtol 1e-5 (bias vectors are the weights' own: exact)."""
    g, r = dict(_leaves(got)), dict(_leaves(ref))
    assert sorted(g) == sorted(r)
    for k, v in r.items():
        a, b = g[k].cpu(), v
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k.endswith("wq"):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
        elif k == "backbone/stem_u8/bias":
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=k)
        elif k.endswith("/bias"):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=k)


@pytest.mark.parametrize("which", ["fast", "parity"])
def test_prepare_quantized_matches_jax(which, request):
    """The port's calibration and quantization of its own folded state
    against the reference's prepare_quantized, loaded by from_jax_quant."""
    s = request.getfixturevalue(which)
    got = tq.prepare_quantized(s.state, s.imgs, s.cfg, device="cpu")
    assert set(got) == {"backbone", "fpn", "rpn", "pyr", "box", "mask"}
    _assert_quant_trees_match(got, from_jax_quant(s.jquant))


def test_prepare_int8_params_matches_jax(fast):
    """The legacy ``backbone_q`` group against the reference's
    prepare_int8_params, and its place in a state that from_jax_params
    loads: the tree an ``int8_backbone`` config runs."""
    ref = jax.device_get(jq.prepare_int8_params(fast.tree, fast.imgs,
                                                fast.cfg))
    got = tq.prepare_int8_params(fast.state, fast.imgs, fast.cfg,
                                 device="cpu")
    _assert_quant_trees_match({"backbone": got},
                              from_jax_quant({"backbone": ref}))
    loaded = from_jax_params(dict(fast.tree, backbone_q=ref))["backbone_q"]
    _assert_quant_trees_match({"backbone": got}, {"backbone": loaded})


def test_calibrate_backbone_scales_match_jax(fast):
    x = j_preprocess(jnp.asarray(fast.imgs), fast.cfg, 64)
    ref = jq.calibrate_backbone(fast.tree["backbone"], x)
    got = tq.calibrate_backbone(from_jax_params(fast.tree)["backbone"],
                                _nchw(np.asarray(x)))
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose([got[k] for k in ref], list(ref.values()),
                               rtol=1e-5)


def _units(tree, state):
    """(name, reference unit, port unit, layout axis) for each kind."""
    bb, tb = tree["backbone"]["res3"][0], state["backbone"]["res3"][0]
    return [("conv_bn 3x3", bb["conv2"], tb["conv2"], jq.quantize_unit,
             tq.quantize_unit),
            ("conv_bn 1x1", bb["shortcut"], tb["shortcut"], jq.quantize_unit,
             tq.quantize_unit),
            ("plain conv", tree["fpn"]["output3"], state["fpn"]["output3"],
             jq.quantize_plain, tq.quantize_plain),
            ("linear", tree["box_head"]["fc1"], state["box_head"]["fc1"],
             jq.quantize_plain, tq.quantize_plain),
            ("deconv", tree["mask_head"]["deconv"],
             state["mask_head"]["deconv"], jq.quantize_deconv,
             tq.quantize_deconv)]


@pytest.mark.parametrize("kind", ["conv_bn 3x3", "conv_bn 1x1", "plain conv",
                                  "linear", "deconv"])
def test_quantized_units_equal_jax_given_the_scale(kind, fast):
    name, ref_p, port_p, jfn, tfn = next(
        u for u in _units(fast.tree, fast.state) if u[0] == kind)
    layout = {"deconv": "mask/deconv", "linear": "box/fc1"}.get(
        kind, "fpn/output3")
    ref = from_jax_quant(_single(layout, jax.device_get(jfn(ref_p, 0.037))))
    got = tfn(port_p, 0.037)
    for k in ("wq", "mult", "bias", "sa"):
        torch.testing.assert_close(got[k], _get(ref, layout)[k], rtol=0,
                                   atol=0, msg=k)


def _single(path: str, unit: dict) -> dict:
    """A quant tree holding one unit at ``path`` (group/name), the rest of
    its group filled so that from_jax_quant recognises the group."""
    group, name = path.split("/")
    if group == "fpn":
        return {"fpn": {f"{k}{i}": unit for i in range(2, 6)
                        for k in ("lateral", "output")}}
    if group == "box":
        return {"box": {"fc1": unit, "fc2": unit}}
    return {"mask": {"conv1": unit, name: unit}}


def _get(q: dict, path: str) -> dict:
    group, name = path.split("/")
    return q[group][name]


def test_stem_u8_matches_jax(fast):
    """wq and mult exact; the bias map within atol 1e-5."""
    cfg = fast.cfg
    ref = jax.device_get(jq.quantize_stem_u8(fast.tree["backbone"]["stem"],
                                             cfg.pixel_mean, cfg.pixel_std,
                                             64))
    ref = from_jax_quant({"backbone": {"stem": ref, "stem_u8": ref,
                                       "res2": []}})["backbone"]["stem_u8"]
    got = tq.quantize_stem_u8(fast.state["backbone"]["stem"],
                              cfg.pixel_mean, cfg.pixel_std, 64)
    for k in ("wq", "mult", "sa"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)
    assert got["bias"].shape == ref["bias"].shape == (1, 16, 32, 32)
    torch.testing.assert_close(got["bias"], ref["bias"], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# int8 units, exact

def _random_unit(rng, k, cin, cout):
    return {"w": (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
            "bias": rng.normal(size=cout).astype(np.float32)}


def _port_unit(qp: dict) -> dict:
    return from_jax_quant({"fpn": {f"{k}{i}": qp for i in range(2, 6)
                                   for k in ("lateral", "output")}}
                          )["fpn"]["lateral2"]


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (1, 2), (3, 2)])
@pytest.mark.parametrize("streaming", [False, True])
def test_qconv_int8_in_exact(k, stride, streaming):
    """int8 out in a consumer's scale (streaming) or bf16 out: equal to the
    reference's bit for bit."""
    rng = np.random.default_rng(10 * k + stride)
    qp = jax.device_get(jq.quantize_unit(_random_unit(rng, k, 48, 40), 0.03))
    x = rng.integers(-127, 128, (2, 13, 13, 48)).astype(np.int8)
    sa = jnp.float32(0.05) if streaming else None
    ref = _f(jq.qconv_int8_in(jnp.asarray(x), qp, stride=stride, relu=True,
                              sa_out=sa))
    got = tq.qconv_int8_in(_nchw(x), _port_unit(qp), stride=stride,
                           relu=True,
                           sa_out=None if sa is None else torch.tensor(0.05))
    assert got.dtype == (torch.int8 if streaming else torch.bfloat16)
    np.testing.assert_array_equal(_nhwc(got), ref)


def test_qconv_int8_in_mult_override_exact():
    """The pyramid RPN's per-level multiplier, no ReLU."""
    rng = np.random.default_rng(3)
    qp = jax.device_get(jq.quantize_unit(_random_unit(rng, 3, 32, 32), 0.02))
    mult = rng.uniform(1e-4, 1e-3, 32).astype(np.float32)
    x = rng.integers(-127, 128, (2, 9, 9, 32)).astype(np.int8)
    ref = _f(jq.qconv_int8_in(jnp.asarray(x), qp, relu=False,
                              sa_out=jnp.float32(0.01),
                              mult=jnp.asarray(mult)))
    got = tq.qconv_int8_in(_nchw(x), _port_unit(qp), relu=False,
                           sa_out=torch.tensor(0.01),
                           mult=torch.from_numpy(mult))
    np.testing.assert_array_equal(_nhwc(got), ref)


@pytest.mark.parametrize("op", ["deconv", "deconv_streaming", "linear",
                                "linear_relu", "max_pool"])
def test_int8_ops_exact(op):
    rng = np.random.default_rng(7)
    if op.startswith("deconv"):
        p = {"w": (rng.normal(size=(2, 2, 24, 32)) * 0.1).astype(np.float32),
             "b": rng.normal(size=24).astype(np.float32)}
        qp = jax.device_get(jq.quantize_deconv(p, 0.04))
        x = rng.integers(-127, 128, (3, 7, 7, 32)).astype(np.int8)
        sa = jnp.float32(0.08) if op.endswith("streaming") else None
        ref = _f(jq.qdeconv_int8_in(jnp.asarray(x), qp, sa_out=sa))
        tqp = from_jax_quant({"mask": {"conv1": jq.quantize_plain(
            {"w": np.zeros((3, 3, 4, 4), np.float32),
             "b": np.zeros(4, np.float32)}, 1.0), "deconv": qp}}
        )["mask"]["deconv"]
        got = _nhwc(tq.qdeconv_int8_in(
            _nchw(x), tqp, sa_out=None if sa is None else torch.tensor(0.08)))
    elif op.startswith("linear"):
        p = {"w": (rng.normal(size=(392, 64)) * 0.05).astype(np.float32),
             "b": rng.normal(size=64).astype(np.float32)}
        qp = jax.device_get(jq.quantize_plain(p, 0.02))
        x = (rng.normal(size=(50, 392)) * 0.8).astype(np.float32)
        relu = op.endswith("relu")
        ref = _f(jq.qlinear(jnp.asarray(x), qp, relu=relu))
        tqp = from_jax_quant({"box": {"fc1": qp, "fc2": qp}})["box"]["fc1"]
        got = tq.qlinear(torch.from_numpy(x), tqp, relu=relu).float().numpy()
    else:
        x = rng.integers(-127, 128, (2, 15, 15, 8)).astype(np.int8)
        ref = _f(jq.max_pool_i8(jnp.asarray(x)))
        got = _nhwc(tq.max_pool_i8(_nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# int8 stages on the reference's quant tree

@pytest.mark.parametrize("stem", ["u8", "calibrated"])
@pytest.mark.parametrize("pyramid", [False, True])
def test_resnet_forward_int8_exact(stem, pyramid, fast):
    qb = dict(fast.jquant["backbone"])
    if stem == "u8":
        x_j, x_t = jnp.asarray(fast.imgs), _nchw(fast.imgs)
    else:
        del qb["stem_u8"]
        x = np.asarray(j_preprocess(jnp.asarray(fast.imgs), fast.cfg, 64))
        x_j, x_t = jnp.asarray(x), _nchw(x)
    res_sa = fast.jquant["pyr"]["res_sa"] if pyramid else None
    ref = jq.resnet_forward_int8(qb, x_j, out_sas=res_sa)
    tqb = from_jax_quant({"backbone": qb})["backbone"]
    got = tq.resnet_forward_int8(
        tqb, x_t, out_sas=None if res_sa is None else torch.from_numpy(
            np.asarray(res_sa)))
    for n in ("res2", "res3", "res4", "res5"):
        assert got[n].dtype == (torch.int8 if pyramid else torch.bfloat16)
        np.testing.assert_array_equal(_nhwc(got[n]), _f(ref[n]), err_msg=n)


def _stage_inputs(s):
    """The reference's int8 stage outputs and bf16 FPN levels of s.imgs, as
    numpy, with the port's quant tree."""
    q = s.jquant
    res = jq.resnet_forward_int8(q["backbone"], jnp.asarray(s.imgs),
                                 out_sas=q["pyr"]["res_sa"])
    return q, {k: np.asarray(v) for k, v in res.items()}, from_jax_quant(q)


@pytest.mark.parametrize("tree", ["lat_sa", "legacy"])
def test_fpn_and_rpn_int8_pyramid_exact(tree, fast):
    """fpn_forward_int8_pyr (the int8 top-down pathway, and the legacy tree
    with bf16 top-down sums) and rpn_head_forward_int8_pyr."""
    q, res, tquant = _stage_inputs(fast)
    pyr, tpyr = dict(q["pyr"]), dict(tquant["pyr"])
    if tree == "legacy":
        del pyr["lat_sa"], tpyr["lat_sa"]
    ref = jq.fpn_forward_int8_pyr(q["fpn"], pyr, {k: jnp.asarray(v)
                                                  for k, v in res.items()},
                                  jnp.float32)
    got = tq.fpn_forward_int8_pyr(tquant["fpn"], tpyr,
                                  {k: _nchw(v) for k, v in res.items()},
                                  torch.float32)
    assert len(got) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(_nhwc(g), _f(r), err_msg=f"P{i + 2}")
    rl, rd = jq.rpn_head_forward_int8_pyr(q["rpn"], pyr, ref,
                                          fast.cfg.num_anchors)
    gl, gd = tq.rpn_head_forward_int8_pyr(tquant["rpn"], tpyr, got)
    for g, r in zip(gl + gd, rl + rd):
        np.testing.assert_array_equal(g.float().numpy(), _f(r))


def test_fpn_and_rpn_int8_on_bf16_stages_exact(fast):
    """Scope "convnet"/"full" without the pyramid: bf16 stage outputs,
    quantized FPN and RPN head."""
    q, tquant = fast.jquant, from_jax_quant(fast.jquant)
    res = jq.resnet_forward_int8(q["backbone"], jnp.asarray(fast.imgs))
    ref = jq.fpn_forward_int8(q["fpn"], res, jnp.float32)
    got = tq.fpn_forward_int8(tquant["fpn"],
                              {k: _nchw(_f(v)).to(torch.bfloat16)
                               for k, v in res.items()}, torch.float32)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_nhwc(g), _f(r), err_msg=f"P{i + 2}")
    rl, rd = jq.rpn_head_forward_int8(q["rpn"], ref, fast.cfg.num_anchors)
    gl, gd = tq.rpn_head_forward_int8(tquant["rpn"], got)
    for g, r in zip(gl + gd, rl + rd):
        np.testing.assert_array_equal(g.float().numpy(), _f(r))
