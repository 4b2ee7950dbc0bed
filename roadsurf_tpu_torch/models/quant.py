"""Static-int8 inference for the conv stack and the heads: calibration,
quantization and the int8 forward.

Port of the reference's ``models/quant.py``; the scheme is its own
(post-training static quantization):

* weights: per-output-channel symmetric int8 of the FrozenBN-folded weight,
  ``sw[c] = max |w[c]| / 127``, ``wq = clip(round(w / sw), ±127)``;
* activations: one symmetric scale per unit input, ``sa = max |x| / 127``
  over one calibration batch of the float32 model;
* a unit's epilogue turns the conv sum into ``y = acc·mult + bias``
  (``mult = sa·sw``), ReLU, and either bf16 or, streaming, the consumer's
  int8 ``clip(round(y · (1/sa_out)), ±127)``.

Arithmetic, chosen so that the port equals the reference bit for bit on
the CPU (``tests/test_torch_port_quant.py``):

* the int8 operands of a conv, deconv or linear are cast to float32, so
  each product is exact and every partial sum below 2²⁴ is the exact
  integer, in any order. (Cast to bf16, cuDNN returns bf16 and rounds the
  sum.) On the card these products may take TF32 (:func:`tf32`): int8
  values fit its 10-bit mantissa, so they stay exact;
* the epilogue is separate float32 operations in the reference's order,
  the reciprocal of ``sa_out`` taken in float32 first, no fused
  multiply-add;
* a quantization divides by a float32 tensor on the operand's device: on
  the card a division by a host number is a product with its rounded
  reciprocal;
* ``round`` is half-to-even, as in the reference.

Layout: activations are NCHW tensors in channels_last memory, int8 or
float; the reference's NHWC reshapes become ``permute(0, 2, 3, 1)`` views.
The calibration forwards and the quantization are float32 computations on
real values and run with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..ops.roi_align import roi_align_multilevel_ref
from ..utils.device import resolve_device
from ..utils.weights import state_to
from .anchors import all_level_anchors
from .fpn import fpn_forward, upsample2x_nearest
from .resnet import conv, max_pool, resnet_forward
from .rpn import select_proposals

_QMAX = 127.0
FLOAT_GROUPS = ("backbone", "fpn", "rpn", "box_head", "mask_head")


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's and cuBLAS's TF32 switches set to ``enabled`` inside the
    block, restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _chan(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over NCHW; a bias map as it is."""
    return v.reshape(-1, 1, 1) if v.dim() == 1 else v


# ---------------------------------------------------------------------------
# int8 forward

def _quantize_act(x: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """float32 x -> int8 ``clip(round(x / sa), ±127)``; ``sa`` a float32
    tensor on x's device."""
    return torch.round(x / sa).clamp_(-_QMAX, _QMAX).to(torch.int8)


def _epilogue(y: torch.Tensor, mult, bias, relu: bool, sa_out):
    """float32 sums (fresh, updated in place) -> bf16, or int8 in the
    ``sa_out`` domain."""
    y.mul_(mult).add_(bias)
    if relu:
        y.clamp_(min=0.0)
    if sa_out is None:
        return y.to(torch.bfloat16)
    return y.mul_(torch.reciprocal(sa_out)).round_().clamp_(
        -_QMAX, _QMAX).to(torch.int8)


def qconv_int8_in(xq, qp, stride=1, relu=True, sa_out=None, mult=None):
    """Conv on an int8 input already in qp's activation domain (the
    reference's padding: k//2 for k > 1). ``sa_out=None`` returns the bf16
    epilogue output, else int8 in the ``sa_out`` domain; ``mult``
    overrides the epilogue multiplier (an input in a per-level scale)."""
    k = qp["wq"].shape[-1]
    with tf32(True):
        y = F.conv2d(xq.float(), qp["wq"].float(), stride=stride,
                     padding=k // 2)
    return _epilogue(y, _chan(qp["mult"] if mult is None else mult),
                     _chan(qp["bias"]), relu, sa_out)


def qconv_unit(x, qp, stride=1, relu=True):
    """float x -> quantized in qp's scale -> conv -> bf16."""
    return qconv_int8_in(_quantize_act(x.float(), qp["sa"]), qp,
                         stride=stride, relu=relu)


def qconv_unit_out(x, qp, sa_out, stride=1, relu=False):
    """float x -> conv -> int8 in ``sa_out`` (streaming epilogue)."""
    return qconv_int8_in(_quantize_act(x.float(), qp["sa"]), qp,
                         stride=stride, relu=relu, sa_out=sa_out)


def qdeconv_int8_in(xq, qp, relu=True, sa_out=None):
    """The mask head's 2x2 stride-2 ConvTranspose on an int8 input in qp's
    domain; same epilogue as :func:`qconv_int8_in`."""
    with tf32(True):
        y = F.conv_transpose2d(xq.float(), qp["wq"].float(), stride=2)
    return _epilogue(y, _chan(qp["mult"]), _chan(qp["bias"]), relu, sa_out)


def qlinear(x, qp, relu=False):
    """Linear on the int8-quantized input (rows of x) and weight; bf16 out."""
    xq = _quantize_act(x.float(), qp["sa"])
    with tf32(True):
        y = F.linear(xq.float(), qp["wq"].float())
    return _epilogue(y, qp["mult"], qp["bias"], relu, None)


def max_pool_i8(x: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3/2 max pool on int8, padding one pixel (the
    reference pads with -128, which never wins over a clipped value ≥
    -127). Runs on an exact bf16 copy: pooling kernels need not take
    int8."""
    return F.max_pool2d(x.to(torch.bfloat16), kernel_size=3, stride=2,
                        padding=1).to(torch.int8)


def _subsample(x: torch.Tensor) -> torch.Tensor:
    """P6: a window-1 stride-2 max is a plain subsample."""
    return x[:, :, ::2, ::2].contiguous(memory_format=torch.channels_last)


def resnet_forward_int8(qparams, images, out_sas=None):
    """images: NCHW preprocessed float, or raw uint8 tiles when
    ``qparams['stem_u8']`` exists (the caller checks its size). Returns
    {'res2'..'res5'} in bf16, or int8 in the per-stage scales ``out_sas``.

    The residual stream is int8: the block input is quantized once into
    its conv1 scale (the shortcut shares it), conv1 -> conv2 -> conv3 carry
    int8 in the consumer's domain, and the block output, summed in float32
    with the shortcut and ReLU'd, is quantized into the next block's conv1
    scale."""
    first = qparams["res2"][0]
    if images.dtype == torch.uint8 and "stem_u8" in qparams:
        # img - 128 is the bit pattern img ^ 0x80: exact int8
        qin = (images ^ 0x80).view(torch.int8)
        x8 = qconv_int8_in(qin, qparams["stem_u8"], stride=2, relu=True,
                           sa_out=first["conv1"]["sa"])
    else:
        stem = qparams["stem"]
        x8 = qconv_int8_in(_quantize_act(images.float(), stem["sa"]), stem,
                           stride=2, relu=True, sa_out=first["conv1"]["sa"])
    x8 = max_pool_i8(x8)
    feats = {}
    stages = ("res2", "res3", "res4", "res5")
    for si, stage in enumerate(stages):
        first_stride = 1 if si == 0 else 2
        blocks = qparams[stage]
        for bi, bp in enumerate(blocks):
            stride = first_stride if bi == 0 else 1
            t = qconv_int8_in(x8, bp["conv1"], stride=stride, relu=True,
                              sa_out=bp["conv2"]["sa"])
            t = qconv_int8_in(t, bp["conv2"], relu=True,
                              sa_out=bp["conv3"]["sa"])
            out = qconv_int8_in(t, bp["conv3"], relu=False)
            if "shortcut" in bp:
                sc = qconv_int8_in(x8, bp["shortcut"], stride=stride,
                                   relu=False).float()
            else:
                sc = x8.float() * bp["conv1"]["sa"]
            h = (out.float() + sc).clamp_(min=0.0)
            if bi + 1 < len(blocks):
                x8 = _quantize_act(h, blocks[bi + 1]["conv1"]["sa"])
            elif si + 1 < len(stages):
                x8 = _quantize_act(h, qparams[stages[si + 1]][0]
                                   ["conv1"]["sa"])
        feats[stage] = h.to(torch.bfloat16) if out_sas is None \
            else _quantize_act(h, out_sas[si])
    return feats


def fpn_forward_int8(qp, feats, dtype):
    """The FPN with quantized laterals and output convs (bf16 out), the
    top-down sums in bf16 cast to ``dtype``; P6 subsampled from P5."""
    names = ["res2", "res3", "res4", "res5"]
    laterals = [qconv_unit(feats[n], qp[f"lateral{i + 2}"], relu=False)
                for i, n in enumerate(names)]
    tds = [None] * 4
    tds[3] = laterals[3]
    for i in (2, 1, 0):
        tds[i] = (laterals[i] + upsample2x_nearest(tds[i + 1])).to(dtype)
    outs = [qconv_unit(tds[i], qp[f"output{i + 2}"], relu=False)
            for i in range(4)]
    outs.append(_subsample(outs[3]))
    return outs


def fpn_forward_int8_pyr(qp, pyr, feats_i8, dtype):
    """The int8-pyramid FPN: int8 ResNet stage outputs (in the laterals'
    input scales) in, [P2..P6] int8 in the per-level scales
    ``pyr['out_sa']`` out. With ``pyr['lat_sa']`` the top-down pathway is
    int8 too: laterals emit int8 in their own scales, the nearest upsample
    replicates int8, and each top-down sum is taken in float32 and
    quantized into the output conv's input scale; without it (the legacy
    tree) the top-down sums are bf16. P6 shares P5's scale."""
    out_sa = pyr["out_sa"]
    names = ["res2", "res3", "res4", "res5"]
    lat_sa = pyr.get("lat_sa")
    if lat_sa is None:
        laterals = [qconv_int8_in(feats_i8[n], qp[f"lateral{i + 2}"],
                                  relu=False) for i, n in enumerate(names)]
        tds = [None] * 4
        tds[3] = laterals[3]
        for i in (2, 1, 0):
            tds[i] = (laterals[i]
                      + upsample2x_nearest(tds[i + 1])).to(dtype)
        outs = [qconv_unit_out(tds[i], qp[f"output{i + 2}"], out_sa[i])
                for i in range(4)]
    else:
        td_sa = [qp[f"output{i + 2}"]["sa"] for i in range(4)]
        laterals = [qconv_int8_in(feats_i8[n], qp[f"lateral{i + 2}"],
                                  relu=False, sa_out=lat_sa[i])
                    for i, n in enumerate(names)]
        tds = [None] * 4
        tds[3] = _quantize_act(laterals[3].float() * lat_sa[3], td_sa[3])
        for i in (2, 1, 0):
            up = upsample2x_nearest(tds[i + 1])
            s = laterals[i].float() * lat_sa[i] + up.float() * td_sa[i + 1]
            tds[i] = _quantize_act(s, td_sa[i])
        outs = [qconv_int8_in(tds[i], qp[f"output{i + 2}"], relu=False,
                              sa_out=out_sa[i]) for i in range(4)]
    outs.append(_subsample(outs[3]))
    return outs


def _rpn_outputs(o, d, logits, deltas):
    b = o.shape[0]
    logits.append(o.permute(0, 2, 3, 1).reshape(b, -1))
    deltas.append(d.permute(0, 2, 3, 1).reshape(b, -1, 4))


def rpn_head_forward_int8(qp, feats):
    """The RPN head on float levels: the shared conv quantizes each level
    in its one scale and streams into the predictors' shared int8 domain;
    bf16 objectness and deltas, rows in (y, x, a) order."""
    logits, deltas = [], []
    for f in feats:
        fq = _quantize_act(f.float(), qp["conv"]["sa"])
        t = qconv_int8_in(fq, qp["conv"], relu=True,
                          sa_out=qp["objectness"]["sa"])
        _rpn_outputs(qconv_int8_in(t, qp["objectness"], relu=False),
                     qconv_int8_in(t, qp["deltas"], relu=False),
                     logits, deltas)
    return logits, deltas


def rpn_head_forward_int8_pyr(qp, pyr, feats_i8):
    """The RPN head on int8 pyramid levels: the shared conv takes each
    level in its own scale, through the per-level multiplier
    ``pyr['rpn_mult']`` = s_level·sw."""
    logits, deltas = [], []
    for li, f in enumerate(feats_i8):
        t = qconv_int8_in(f, qp["conv"], relu=True,
                          sa_out=qp["objectness"]["sa"],
                          mult=pyr["rpn_mult"][li])
        _rpn_outputs(qconv_int8_in(t, qp["objectness"], relu=False),
                     qconv_int8_in(t, qp["deltas"], relu=False),
                     logits, deltas)
    return logits, deltas


# ---------------------------------------------------------------------------
# calibration: activation maxima of the float32 model

def _scales(maxes: dict) -> dict:
    """{unit: max |x| / 127} as Python floats (one device read)."""
    vals = torch.stack(list(maxes.values())).tolist()
    return {k: float(v) / _QMAX for k, v in zip(maxes, vals)}


def calibrate_backbone(params, x) -> dict:
    """{unit path: activation scale} from the |max| of each backbone conv
    unit's input on the preprocessed float32 batch ``x`` (NCHW); paths as
    the reference's: ("stem",), (stage, block, conv)."""
    maxes = {("stem",): x.abs().amax()}
    h = max_pool(conv(x, params["stem"], stride=2, relu=True))
    for si, stage in enumerate(("res2", "res3", "res4", "res5")):
        first_stride = 1 if si == 0 else 2
        for bi, bp in enumerate(params[stage]):
            stride = first_stride if bi == 0 else 1
            maxes[(stage, bi, "conv1")] = h.abs().amax()
            out = conv(h, bp["conv1"], stride=stride, relu=True)
            maxes[(stage, bi, "conv2")] = out.abs().amax()
            out = conv(out, bp["conv2"], relu=True)
            maxes[(stage, bi, "conv3")] = out.abs().amax()
            out = conv(out, bp["conv3"])
            if "shortcut" in bp:
                maxes[(stage, bi, "shortcut")] = h.abs().amax()
                sc = conv(h, bp["shortcut"], stride=stride)
            else:
                sc = h
            h = torch.relu(out + sc)
    return _scales(maxes)


def calibrate_inference(params, x, cfg, image_size: int) -> dict:
    """Activation scales of every unit beyond the backbone, from one
    float32 forward of the pipeline: FPN (lateral and output conv inputs,
    lateral outputs, the P-levels), the RPN head (one scale over all
    levels), proposal selection (no local-max gate, as the reference
    calibrates), the box FCs on the pooled proposals and the mask convs,
    deconv and predictor on the top ``detections_per_image`` proposals.
    The poolers are the plain versions, in float32."""
    S = image_size
    maxes: dict = {}

    def track(name, t):
        v = t.abs().amax()
        maxes[name] = v if name not in maxes else torch.maximum(maxes[name],
                                                                v)

    feats = resnet_forward(params["backbone"], x)
    names = ["res2", "res3", "res4", "res5"]
    fp = params["fpn"]
    for i, n in enumerate(names):
        track(("fpn", f"lateral{i + 2}"), feats[n])
    laterals = [conv(feats[n], fp[f"lateral{i + 2}"])
                for i, n in enumerate(names)]
    tds = [None] * 4
    tds[3] = laterals[3]
    for i in (2, 1, 0):
        tds[i] = laterals[i] + upsample2x_nearest(tds[i + 1])
    for i in range(4):
        track(("fpn", f"output{i + 2}"), tds[i])
    for i in range(4):
        track(("fpn", f"lat_out{i + 2}"), laterals[i])
    fpn_feats = fpn_forward(fp, feats)
    for i, f in enumerate(fpn_feats[:4]):
        track(("fpn_out", i + 2), f)

    rp = params["rpn"]
    logits, deltas = [], []
    for f in fpn_feats:
        track(("rpn", "conv"), f)
        t = torch.relu(conv(f, rp["conv"]))
        track(("rpn", "objectness"), t)
        track(("rpn", "deltas"), t)
        _rpn_outputs(conv(t, rp["objectness"]), conv(t, rp["deltas"]),
                     logits, deltas)
    anchors = all_level_anchors(S, cfg.fpn_strides, cfg.anchor_sizes,
                                cfg.anchor_aspect_ratios, cfg.anchor_offset)
    proposals, _ = select_proposals(
        logits, deltas, anchors, S, cfg.rpn_pre_nms_topk_test,
        cfg.rpn_post_nms_topk_test, cfg.rpn_nms_thresh,
        fast_nms=cfg.fast_nms)

    def pool(boxes, P):
        return roi_align_multilevel_ref(
            [f.permute(0, 2, 3, 1) for f in fpn_feats[:4]], boxes, P,
            sampling=cfg.pooler_sampling_ratio,
            canonical_size=cfg.canonical_box_size,
            canonical_level=cfg.canonical_level)

    bp = params["box_head"]
    xf = pool(proposals, cfg.box_pooler_resolution)
    xf = xf.reshape(xf.shape[0] * xf.shape[1], -1)
    track(("box", "fc1"), xf)
    track(("box", "fc2"),
          torch.relu(F.linear(xf, bp["fc1"]["w"]) + bp["fc1"]["b"]))

    mp = params["mask_head"]
    P = cfg.mask_pooler_resolution
    h = pool(proposals[:, :cfg.detections_per_image], P)
    h = h.reshape(-1, P, P, h.shape[-1]).permute(0, 3, 1, 2)
    for i in range(cfg.mask_num_conv):
        track(("mask", f"conv{i + 1}"), h)
        h = torch.relu(conv(h, mp[f"conv{i + 1}"]))
    track(("mask", "deconv"), h)
    dp = mp["deconv"]
    track(("mask", "predictor"),
          torch.relu(F.conv_transpose2d(h, dp["w"], dp["b"], stride=2)))
    return _scales(maxes)


# ---------------------------------------------------------------------------
# quantization of the port's folded float32 state

def _per_channel(w: torch.Tensor, axis: int, act_scale: float) -> dict:
    """Per-output-channel int8 of ``w`` (output channels on ``axis``)."""
    dims = [d for d in range(w.dim()) if d != axis]
    sw = (w.abs().amax(dim=dims) / _f32(_QMAX, w)).clamp_(min=1e-12)
    shape = [1] * w.dim()
    shape[axis] = -1
    wq = torch.round(w / sw.reshape(shape)).clamp_(-_QMAX, _QMAX) \
        .to(torch.int8)
    return {"wq": wq, "mult": _f32(act_scale, w) * sw,
            "sa": _f32(act_scale, w)}


def quantize_unit(p, act_scale: float) -> dict:
    """A conv unit {w (OIHW, FrozenBN folded), b} -> {wq, mult, bias, sa}
    (the reference folds w·scale in float32 the same way)."""
    return dict(_per_channel(p["w"], 0, act_scale), bias=p["b"])


quantize_plain = quantize_unit          # conv OIHW or linear (out, in)


def quantize_deconv(p, act_scale: float) -> dict:
    """The mask deconv {w (in, out, kh, kw), b}: output channels on 1."""
    return dict(_per_channel(p["w"], 1, act_scale), bias=p["b"])


def quantize_stem_u8(stem_p, pixel_mean, pixel_std, image_size: int) -> dict:
    """The uint8-direct stem: raw tiles enter as the exact int8
    ``img - 128``. 1/std folds into the weights per input channel, and the
    constant offset ``128 - mean`` becomes a bias map: the constant image
    convolved once with the dequantized weights (zero padding, so the map
    varies only where the 7x7 window hangs over the border). Input scale 1;
    bias (1, C, S/2, S/2)."""
    w = stem_p["w"]
    std = torch.tensor(pixel_std, dtype=torch.float32, device=w.device)
    w = w / std.reshape(1, -1, 1, 1)
    q = _per_channel(w, 0, 1.0)
    offs = _f32(128.0, w) - torch.tensor(pixel_mean, dtype=torch.float32,
                                         device=w.device)
    ones = offs.reshape(1, -1, 1, 1).expand(1, 3, image_size, image_size)
    wdq = q["wq"].float() * q["mult"].reshape(-1, 1, 1, 1)
    k = w.shape[-1]
    bmap = F.conv2d(ones.contiguous(), wdq, stride=2, padding=k // 2)
    return {"wq": q["wq"], "mult": q["mult"],
            "bias": stem_p["b"].reshape(1, -1, 1, 1) + bmap, "sa": q["sa"]}


def quantize_backbone(params, act_scales: dict) -> dict:
    """Every backbone unit; the shortcut takes conv1's scale (they read the
    same tensor, which the int8 forward quantizes once)."""
    q: dict = {"stem": quantize_unit(params["stem"], act_scales[("stem",)])}
    for stage in ("res2", "res3", "res4", "res5"):
        blocks = []
        for bi, bp in enumerate(params[stage]):
            blocks.append({
                cv: quantize_unit(bp[cv], act_scales[
                    (stage, bi, "conv1" if cv == "shortcut" else cv)])
                for cv in ("conv1", "conv2", "conv3", "shortcut")
                if cv in bp})
        q[stage] = blocks
    return q


def _calibration_setup(state, images_u8, cfg, image_size, device):
    """(float32 params on the device, preprocessed NCHW batch, S)."""
    from .mask_rcnn import preprocess

    dev = resolve_device(device)
    S = image_size or cfg.min_size_test or images_u8.shape[1]
    params = state_to({k: state[k] for k in FLOAT_GROUPS}, dev,
                      torch.float32)
    x = preprocess(torch.as_tensor(images_u8).to(dev), cfg, S)
    return params, x.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last), S


def _backbone_group(bb, x, cfg, S: int) -> dict:
    """The calibrated backbone with its uint8-direct stem (valid only
    where tiles arrive at native size S; the forward checks)."""
    q = quantize_backbone(bb, calibrate_backbone(bb, x))
    q["stem_u8"] = quantize_stem_u8(bb["stem"], cfg.pixel_mean,
                                    cfg.pixel_std, S)
    return q


def prepare_int8_params(state, images_u8, cfg, image_size=None,
                        device="cuda") -> dict:
    """Calibrate on a uint8 tile batch and quantize the backbone (the
    legacy ``backbone_q`` group, with the uint8-direct stem)."""
    with tf32(False), torch.inference_mode():
        params, x, S = _calibration_setup(state, images_u8, cfg, image_size,
                                          device)
        return _backbone_group(params["backbone"], x, cfg, S)


def prepare_quantized(state, images_u8, cfg, image_size=None,
                      device="cuda") -> dict:
    """Calibrate on a uint8 tile batch and quantize per ``cfg.int8_scope``
    (or the legacy ``int8_backbone``): the tree for ``state['quant']``,
    {'backbone', 'fpn', 'rpn', 'pyr', 'box', 'mask'} with only the groups of
    the scope, on ``device``. Empty when the config asks for no int8."""
    scope = cfg.int8_scope or ("backbone" if cfg.int8_backbone else "")
    if not scope:
        return {}
    with tf32(False), torch.inference_mode():
        params, x, S = _calibration_setup(state, images_u8, cfg, image_size,
                                          device)
        q = {"backbone": _backbone_group(params["backbone"], x, cfg, S)}
        if scope == "backbone":
            return q
        scales = calibrate_inference(params, x, cfg, S)
        q["fpn"] = {k: quantize_plain(params["fpn"][k], scales[("fpn", k)])
                    for k in params["fpn"]}
        # objectness and deltas read the same tensor: one shared scale
        s_t = max(scales[("rpn", "objectness")], scales[("rpn", "deltas")])
        rp = params["rpn"]
        q["rpn"] = {"conv": quantize_plain(rp["conv"], scales[("rpn",
                                                               "conv")]),
                    "objectness": quantize_plain(rp["objectness"], s_t),
                    "deltas": quantize_plain(rp["deltas"], s_t)}
        if cfg.int8_pyramid:
            # per-level P scales (P6 shares P5's), the stage-output scales
            # (the laterals' inputs), the RPN conv's per-level multipliers
            # s_level·sw, and the lateral-output scales of the int8
            # top-down pathway
            out_list = [scales[("fpn_out", i + 2)] for i in range(4)]
            out_list.append(out_list[3])
            mult = q["rpn"]["conv"]["mult"]
            sw = mult / _f32(scales[("rpn", "conv")], mult)
            q["pyr"] = {
                "out_sa": torch.tensor(out_list, dtype=torch.float32,
                                       device=mult.device),
                "res_sa": torch.tensor(
                    [scales[("fpn", f"lateral{i + 2}")] for i in range(4)],
                    dtype=torch.float32, device=mult.device),
                "rpn_mult": torch.stack([_f32(s, mult) * sw
                                         for s in out_list]),
                "lat_sa": torch.tensor(
                    [scales[("fpn", f"lat_out{i + 2}")] for i in range(4)],
                    dtype=torch.float32, device=mult.device),
            }
        if scope == "convnet":
            return q
        bh, mh = params["box_head"], params["mask_head"]
        q["box"] = {k: quantize_plain(bh[k], scales[("box", k)])
                    for k in ("fc1", "fc2")}
        q["mask"] = {f"conv{i + 1}": quantize_plain(
            mh[f"conv{i + 1}"], scales[("mask", f"conv{i + 1}")])
            for i in range(cfg.mask_num_conv)}
        q["mask"]["deconv"] = quantize_deconv(mh["deconv"],
                                              scales[("mask", "deconv")])
        q["mask"]["predictor"] = quantize_plain(
            mh["predictor"], scales[("mask", "predictor")])
    return q
