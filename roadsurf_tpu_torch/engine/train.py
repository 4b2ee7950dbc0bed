"""Training engine: target assignment, sampling, losses and the SGD step.

Port of the reference's ``engine/train.py``: the detectron2 training
recipe of ``config/detectron2_config_3bands.yaml`` (solver :268-305, RPN
sampling :222-251, ROI sampling :177-194) at fixed shapes, every sampling
step a masked ranking of random priorities.

What differs from the reference, and why:

* **Random draws are inputs.** PyTorch cannot reproduce ``jax.random``, so
  :func:`compute_losses` takes every uniform it samples with as a tensor
  (``draws``: the RPN's positive and negative priorities, the ROI
  sampler's and its pick, the mask pick; :func:`draw_uniforms`). The
  trainer draws them from a ``torch.Generator`` seeded from (seed, step),
  so a resumed run draws what the uninterrupted one would have.
* **One step per config and size** (:func:`train_step`, cached) replaces
  the reference's ``jitted_train_step``: PyTorch runs eagerly, there is
  nothing to compile. :func:`make_train_scan_step` (k steps in one XLA
  dispatch there) is k steps in one CUDA graph here, replayed with one
  host call (``utils/graphs.py``); each step's uniforms are drawn outside
  the graph and its learning rate is a device tensor, so the k steps
  compute what k calls of the step compute.
* **FrozenBN** is folded into each backbone conv inside autograd every
  step (``utils.weights.fold_unit``), as the reference folds it inside its
  forward, so the gradient reaches ``w`` as there; frozen leaves (every
  ``scale`` and ``bias``, the stem and ``res2`` at ``freeze_at`` 2) take
  no gradient and the update never touches them.
* **Poolers.** On the card both poolers' forwards are K1 or K2 and their
  backward is K5 (``ops/roi_align.py``); the reference trains through its
  XLA separable pooler.
* **Data parallelism** (``group``: ``parallel.mesh.DataParallelGroup``)
  has the reference's global-batch semantics, which jit's psum gives its
  mesh step, with explicit collectives: every normaliser takes the global
  batch (B·world) and the mask loss the global count of valid mask ROIs
  (summed over the ranks before the division), so each rank's ``total``
  is its share of the global loss; the gradients are summed over the
  ranks in one flat buffer, and weight decay and momentum follow the sum
  identically on every rank, so the parameters stay bitwise equal. Every
  rank draws the global batch's uniforms and keeps its rows.

Master weights stay float32; the forward casts them to the compute dtype
each step (bf16 for the YAML, float32 in the CPU parity tests).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.anchors import all_level_anchors, anchors_on, box_iou, \
    get_deltas
from ..models.config import ModelConfig
from ..models.fpn import fpn_forward
from ..models.mask_rcnn import preprocess
from ..models.resnet import resnet_forward
from ..models.roi_heads import box_head_forward, mask_head_forward
from ..models.rpn import rpn_head_forward, select_proposals
from ..ops.nms import top_k
from ..utils.device import compute_dtype, device_constant, resolve_device
from ..utils.graphs import CapturedGraph, storage_key
from ..utils.weights import fold_unit


# ---------------------------------------------------------------------------
# matching & sampling (fixed shape, batched over images)

def match_to_gt(boxes, gt_boxes, gt_valid, thresholds,
                allow_low_quality: bool = False):
    """detectron2 Matcher. boxes (N, 4) or (B, N, 4), gt_boxes (B, G, 4),
    gt_valid (B, G) -> (matched gt index (B, N), label (B, N): 1 fg, 0 bg,
    -1 ignore). The first maximum wins ties, as ``jnp.argmax``."""
    iou = box_iou(boxes, gt_boxes)                              # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou, _ = iou.max(dim=-1)
    matched = torch.argmax(iou, dim=-1)
    lo, hi = thresholds
    one, zero = torch.ones_like(matched), torch.zeros_like(matched)
    label = torch.where(max_iou >= hi, one,
                        torch.where(max_iou < lo, zero, -one))
    label = torch.where(max_iou <= 0.0, zero, label)
    if allow_low_quality:
        # the boxes that hold a GT's best IoU are forced positive
        gt_best = iou.max(dim=-2).values[:, None, :]            # (B, 1, G)
        is_best = (iou == gt_best) & (gt_best > 0) & gt_valid[:, None, :]
        label = torch.where(is_best.any(dim=-1), one, label)
    return matched, label


def _rank(mask, u):
    """Each set entry's rank among the set ones by its priority ``u``
    (stable ascending), n for the others."""
    n = mask.shape[-1]
    r = torch.where(mask, u, torch.full_like(u, 2.0))
    order = torch.argsort(r, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(n, device=u.device)
                  .expand_as(order))
    return torch.where(mask, rank, torch.full_like(rank, n))


def subsample(label, num_samples: int, positive_fraction: float, pos_u,
              neg_u):
    """detectron2 subsample_labels at static shapes: up to
    num_samples·positive_fraction positives, the rest negatives, each the
    lowest of their priorities ``pos_u``/``neg_u`` (uniforms, label's
    shape). Returns (pos_sel, neg_sel) masks."""
    pos, neg = label == 1, label == 0
    pos_quota = int(num_samples * positive_fraction)
    pos_sel = pos & (_rank(pos, pos_u) < pos_quota)
    num_pos = pos_sel.sum(dim=-1, keepdim=True)
    neg_sel = neg & (_rank(neg, neg_u) < num_samples - num_pos)
    return pos_sel, neg_sel


def gather_topk_mask(mask, u, k: int):
    """Up to k set entries of ``mask`` in the order of their priorities
    1 + u (ties to the lower index, as ``lax.top_k``): (idx (..., k),
    valid (..., k))."""
    pri = torch.where(mask, 1.0 + u, torch.zeros_like(u))
    vals, idx = top_k(pri, k)
    return idx, vals > 0.5


# ---------------------------------------------------------------------------
# losses

def smooth_l1(pred, target, beta: float):
    diff = (pred - target).abs()
    if beta <= 1e-8:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def bce_with_logits(logits, targets):
    return logits.clamp(min=0) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))


def softmax_ce(logits, labels, num_classes: int):
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(logp.dtype)
    return -(onehot * logp).sum(dim=-1)


def crop_mask_targets(gt_masks, boxes, out: int, owner=None):
    """Bilinearly crop full-tile instance bitmaps to per-ROI targets, the
    reference's f32 operations in its order. gt_masks (N, S, S) uint8 or
    float in {0, 1}, boxes (M, 4) XYXY in tile coordinates, ``owner`` (M,)
    the bitmap of each ROI (default: ROI i reads bitmap i, the reference's
    form) -> (M, out, out) in {0, 1} float32."""
    S = gt_masks.shape[-1]
    M = boxes.shape[0]
    dev = boxes.device
    if owner is None:
        owner = torch.arange(M, device=dev)
    u = (torch.arange(out, dtype=torch.float32, device=dev) + 0.5) \
        / device_constant(float(out), dev, torch.float32)
    x = boxes[:, 0:1] + u[None, :] * (boxes[:, 2:3] - boxes[:, 0:1])
    y = boxes[:, 1:2] + u[None, :] * (boxes[:, 3:4] - boxes[:, 1:2])
    px = (x - 0.5).clamp(0.0, S - 1.0)
    py = (y - 0.5).clamp(0.0, S - 1.0)
    # indices clamped as the reference's gather clamps them (a NaN box
    # reads cell 0 there, and here)
    x0 = torch.floor(px).long().clamp(0, S - 1)
    y0 = torch.floor(py).long().clamp(0, S - 1)
    x1 = (x0 + 1).clamp(max=S - 1)
    y1 = (y0 + 1).clamp(max=S - 1)
    wx1 = px - x0
    wy1 = py - y0
    m = owner[:, None, None]

    def gather(yy, xx):
        return gt_masks[m, yy[:, :, None], xx[:, None, :]].float()

    vals = (gather(y0, x0) * ((1 - wy1)[:, :, None] * (1 - wx1)[:, None, :])
            + gather(y0, x1) * ((1 - wy1)[:, :, None] * wx1[:, None, :])
            + gather(y1, x0) * (wy1[:, :, None] * (1 - wx1)[:, None, :])
            + gather(y1, x1) * (wy1[:, :, None] * wx1[:, None, :]))
    return (vals >= 0.5).float()


# ---------------------------------------------------------------------------
# the training forward

def sample_sizes(cfg: ModelConfig, image_size: int, G: int) -> dict:
    """The static sizes of the sampling draws: N anchors, R proposals + G
    GT boxes, T ROIs an image."""
    n_anchors = sum(len(a) for a in all_level_anchors(
        image_size, cfg.fpn_strides, cfg.anchor_sizes,
        cfg.anchor_aspect_ratios, cfg.anchor_offset))
    n_props = cfg.rpn_post_nms_topk_train + G
    return {"rpn_pos": n_anchors, "rpn_neg": n_anchors,
            "roi_pos": n_props, "roi_neg": n_props, "roi_pick": n_props,
            "mask_pick": min(cfg.roi_batch_per_image, n_props)}


def draw_uniforms(cfg: ModelConfig, image_size: int, B: int, G: int,
                  generator: torch.Generator) -> dict:
    """Every uniform :func:`compute_losses` samples with, (B, n) float32
    each, on the generator's device."""
    return {k: torch.rand((B, n), generator=generator,
                          device=generator.device)
            for k, n in sample_sizes(cfg, image_size, G).items()}


def tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists, ``path`` the
    leaf's keys and indices."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves(tree) -> list:
    """(path, leaf) of every leaf, in the tree's order."""
    out = []
    tree_map(lambda path, t: out.append((path, t)), tree)
    return out


def _cast(tree, dtype):
    """Differentiable casts of a parameter tree to the compute dtype, 4-d
    weights in channels_last memory."""
    def cast(_, t):
        t = t.to(dtype)
        return t.contiguous(memory_format=torch.channels_last) \
            if t.dim() == 4 else t

    return tree_map(cast, tree)


def fold_backbone(params: dict, dtype) -> dict:
    """The backbone's units folded (``w·scale``, in float32) and cast to
    the compute dtype, inside autograd."""
    def unit(p):
        return _cast(fold_unit(p), dtype)

    out = {"stem": unit(params["stem"])}
    for stage in ("res2", "res3", "res4", "res5"):
        out[stage] = [{n: unit(u) for n, u in bp.items()}
                      for bp in params[stage]]
    return out


def _remat(cfg):
    if cfg.train_remat:
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)
    return lambda fn, *args: fn(*args)


@functools.lru_cache(maxsize=16)
def _anchors(image_size: int, cfg: ModelConfig, device: torch.device):
    """The levels' anchors on ``device`` and their concatenation, made
    once (see ``utils.device.device_constant``)."""
    levels = anchors_on(image_size, cfg.fpn_strides, cfg.anchor_sizes,
                        cfg.anchor_aspect_ratios, cfg.anchor_offset, device)
    return levels, torch.cat(levels, dim=0)


def compute_losses(params: dict, batch: dict, draws: dict,
                   cfg: ModelConfig, image_size: int, group=None) -> dict:
    """The training losses of a batch (tensors on one device): image (B, S,
    S, 3) uint8, gt_boxes (B, G, 4) f32, gt_classes (B, G) int, gt_valid
    (B, G) bool, gt_masks (B, G, S, S) uint8; ``draws`` from
    :func:`draw_uniforms`, B rows. Returns the reference's loss dict of 0-d
    float32 tensors, ``total`` their sum.

    With ``group`` the batch is this rank's share of a global batch of
    B·world images, and the losses are this rank's shares of the global
    batch's: every normaliser counts the global batch, and the mask loss
    the valid mask ROIs of all ranks."""
    dtype = compute_dtype(cfg)
    images = batch["image"]
    gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]
    gt_classes = batch["gt_classes"].long()
    B, S, G = images.shape[0], image_size, gt_boxes.shape[1]
    Bg = B * (group.world if group is not None else 1)
    dev = images.device
    remat = _remat(cfg)
    x = preprocess(images, cfg, S).to(dtype).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)

    backbone = fold_backbone(params["backbone"], dtype)
    feats = remat(resnet_forward, backbone, x)
    fpn = _cast(params["fpn"], dtype)
    fpn_feats = remat(fpn_forward, fpn, feats)
    logits, deltas = rpn_head_forward(_cast(params["rpn"], dtype), fpn_feats,
                                      cfg.num_anchors)
    level_anchors, anchors = _anchors(S, cfg, dev)
    all_logits = torch.cat(logits, dim=1).float()
    all_deltas = torch.cat(deltas, dim=1).float()

    # ---- RPN losses -------------------------------------------------------
    matched, label = match_to_gt(anchors, gt_boxes, gt_valid,
                                 cfg.rpn_iou_thresholds,
                                 allow_low_quality=True)
    pos_sel, neg_sel = subsample(label, cfg.rpn_batch_per_image,
                                 cfg.rpn_positive_fraction,
                                 draws["rpn_pos"], draws["rpn_neg"])
    sel = pos_sel | neg_sel
    obj = torch.where(sel, bce_with_logits(all_logits, (label == 1).float()),
                      torch.zeros_like(all_logits)).sum(dim=-1)
    tgt = get_deltas(anchors, torch.gather(
        gt_boxes, 1, matched[..., None].expand(-1, -1, 4)),
        cfg.rpn_bbox_weights)
    reg = smooth_l1(all_deltas, tgt, cfg.rpn_smooth_l1_beta).sum(dim=-1)
    reg = torch.where(pos_sel, reg, torch.zeros_like(reg)).sum(dim=-1)
    norm = Bg * cfg.rpn_batch_per_image
    loss_rpn_cls = obj.sum() / norm
    loss_rpn_reg = reg.sum() / norm

    # ---- proposals (no gradient through the RPN outputs) ------------------
    with torch.no_grad():
        proposals, _ = select_proposals(
            [lg.detach() for lg in logits], [d.detach() for d in deltas],
            level_anchors, S, cfg.rpn_pre_nms_topk_train,
            cfg.rpn_post_nms_topk_train, cfg.rpn_nms_thresh)
    # append the GT boxes (PROPOSAL_APPEND_GT)
    proposals = torch.cat([proposals, gt_boxes], dim=1)

    # ---- ROI sampling -----------------------------------------------------
    T = min(cfg.roi_batch_per_image, proposals.shape[1])
    matched, label = match_to_gt(proposals, gt_boxes, gt_valid,
                                 (cfg.roi_iou_threshold,
                                  cfg.roi_iou_threshold))
    pos_sel, neg_sel = subsample(label, T, cfg.roi_positive_fraction,
                                 draws["roi_pos"], draws["roi_neg"])
    idx, s_valid = gather_topk_mask(pos_sel | neg_sel, draws["roi_pick"], T)
    s_pos = torch.gather(pos_sel, 1, idx) & s_valid
    s_matched = torch.gather(matched, 1, idx)
    K = cfg.num_classes
    s_cls = torch.gather(gt_classes, 1, s_matched)
    s_cls = torch.where(s_pos, s_cls, torch.full_like(s_cls, K))
    s_cls = torch.where(s_valid, s_cls, torch.full_like(s_cls, K))
    s_props = torch.gather(proposals, 1, idx[..., None].expand(-1, -1, 4))

    # ---- box head ---------------------------------------------------------
    # the poolers read NHWC views of the channels_last levels; the
    # gradient flows back through the permute
    feats4 = [f.permute(0, 2, 3, 1).contiguous() for f in fpn_feats[:4]]
    class_logits, box_deltas = remat(
        lambda p, f, b: box_head_forward(p, f, b, cfg),
        _cast(params["box_head"], dtype), feats4, s_props)
    cls_el = softmax_ce(class_logits.float(), s_cls, K + 1)
    loss_cls = torch.where(s_valid, cls_el, torch.zeros_like(cls_el)).sum() \
        / (Bg * T)
    matched_boxes = torch.gather(gt_boxes, 1,
                                 s_matched[..., None].expand(-1, -1, 4))
    tgt_deltas = get_deltas(s_props, matched_boxes, cfg.box_bbox_weights)
    fg_cls = s_cls.clamp(0, K - 1)
    pred = torch.gather(box_deltas.float(), 2,
                        fg_cls[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    reg_el = smooth_l1(pred, tgt_deltas, 0.0).sum(dim=-1)
    loss_box_reg = torch.where(s_pos, reg_el, torch.zeros_like(reg_el)) \
        .sum() / (Bg * T)

    # ---- mask head --------------------------------------------------------
    M = int(T * cfg.roi_positive_fraction)
    cap = int(cfg.train_mask_rois or 0)
    if cap > 0:
        M = min(M, cap)      # static pad budget; see ModelConfig
    m_idx, m_valid = gather_topk_mask(s_pos, draws["mask_pick"], M)
    m_props = torch.gather(s_props, 1, m_idx[..., None].expand(-1, -1, 4))
    m_matched = torch.gather(s_matched, 1, m_idx)
    m_cls = torch.gather(s_cls, 1, m_idx)
    res = 2 * cfg.mask_pooler_resolution
    mask_params = _cast(params["mask_head"], dtype)

    def mask_branch(p, f4, props, matched_, cls_, valid, gt_masks):
        """Pool, convs, deconv, target crop and the masked BCE sum of a
        group of images: (loss numerator, #valid ROIs), summed over
        groups."""
        logits_ = mask_head_forward(p, f4, props, cfg)
        sel_ = torch.gather(logits_, -1, cls_.clamp(0, K - 1)[
            :, :, None, None, None].expand(logits_.shape[:-1] + (1,)))[..., 0]
        # the ROIs' bitmaps read in place: (b, G, S, S) as (b·G, S, S)
        b_, m_ = props.shape[:2]
        owner = torch.arange(b_, device=dev)[:, None] * G + matched_
        tgt_ = crop_mask_targets(gt_masks.reshape(b_ * G, S, S),
                                 props.reshape(b_ * m_, 4), res,
                                 owner.reshape(-1))
        el = bce_with_logits(sel_.float(), tgt_.reshape(sel_.shape))
        return (torch.where(valid[:, :, None, None], el,
                            torch.zeros_like(el)).sum(), valid.sum())

    chunks = int(cfg.train_head_chunks or 1)
    groups = chunks if chunks > 1 and B % chunks == 0 else 1
    step = B // groups
    mask_sum, n_valid = 0.0, 0
    for g0 in range(0, B, step):
        s_ = slice(g0, g0 + step)
        part, count = remat(mask_branch, mask_params,
                            [f[s_] for f in feats4], m_props[s_],
                            m_matched[s_], m_cls[s_], m_valid[s_],
                            batch["gt_masks"][s_])
        mask_sum, n_valid = mask_sum + part, n_valid + count
    if group is not None:
        # the global count (an integer, exact in float32 below 2^24; no
        # gradient), summed over the ranks before the division
        n_valid = group.all_reduce([n_valid.to(torch.float32)])[0] \
            .to(n_valid.dtype)
    loss_mask = mask_sum / (n_valid.clamp(min=1) * res * res)

    losses = {"loss_rpn_cls": loss_rpn_cls, "loss_rpn_loc": loss_rpn_reg,
              "loss_cls": loss_cls, "loss_box_reg": loss_box_reg,
              "loss_mask": loss_mask}
    losses["total"] = sum(losses.values())
    return losses


# ---------------------------------------------------------------------------
# optimizer: SGD + momentum + WarmupMultiStepLR (the reference's solver)

def lr_schedule(step: int, cfg: ModelConfig) -> float:
    """The learning rate of step ``step``, computed in float32 as the
    reference computes it; a Python float holding that float32 value."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp(s / torch.tensor(float(cfg.warmup_iters)), max=1.0)
    factor = cfg.warmup_factor + (1.0 - cfg.warmup_factor) * warm
    milestones = torch.tensor(cfg.steps, dtype=torch.float32)
    ndecay = (s >= milestones).sum().to(torch.float32)
    gamma = torch.tensor(cfg.gamma, dtype=torch.float32)
    return float(cfg.base_lr * factor * gamma ** ndecay)


def _is_frozen(path, freeze_at: int = 2) -> bool:
    """FrozenBN affine params never train (detectron2 FrozenBatchNorm), and
    the stem/res2 stages are fully frozen per BACKBONE.FREEZE_AT. ``path``:
    the leaf's keys in the parameter tree."""
    keys = list(path)
    if "backbone" not in keys:
        return False
    if keys[-1] in ("scale", "bias"):
        return True
    if freeze_at >= 1 and "stem" in keys:
        return True
    if freeze_at >= 2 and "res2" in keys:
        return True
    return False


def init_train_state(params: dict, cfg: ModelConfig, seed: int = 7,
                     device="cuda") -> dict:
    """A train state from the port's train-state parameters
    (``utils.weights.from_jax_train_params``): float32 master weights on
    ``device``, the non-frozen ones requiring gradients; zero velocity;
    step 0; the sampling seed."""
    def place(path, t):
        t = t.detach().to(device=device, dtype=torch.float32).clone()
        return t.requires_grad_(not _is_frozen(path, cfg.freeze_at))

    params = tree_map(place, params)
    return {"params": params,
            "velocity": tree_map(lambda _, t: torch.zeros_like(
                t, requires_grad=False), params),
            "step": 0, "seed": int(seed)}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampling generator of step ``step``: seeded from (seed, step),
    so a resumed run draws what the uninterrupted one would have."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 32) | int(step))
    return g


def _trainable(state: dict, cfg: ModelConfig) -> tuple[list, list]:
    """The non-frozen parameters and their velocities, in the tree's
    order."""
    ps, vs = zip(*[(p, v) for (path, p), (_, v) in zip(
        leaves(state["params"]), leaves(state["velocity"]))
        if not _is_frozen(path, cfg.freeze_at)])
    return list(ps), list(vs)


def _sgd_step(cfg: ModelConfig, image_size: int, params: dict, ps: list,
              vs: list, batch: dict, draws: dict, lr, group=None) -> dict:
    """The losses of ``batch``, their gradients (summed over ``group``'s
    ranks) and the update of ``ps`` and ``vs`` in place; ``lr`` a number,
    or a 0-d float32 tensor on their device. Returns the losses."""
    losses = compute_losses(params, batch, draws, cfg, image_size, group)
    grads = list(torch.autograd.grad(losses["total"], ps))
    if group is not None:
        grads = group.all_reduce(grads)
    with torch.no_grad():
        g = torch._foreach_add(grads,
                               torch._foreach_mul(ps, cfg.weight_decay))
        torch._foreach_mul_(vs, cfg.momentum)
        torch._foreach_add_(vs, g)
        torch._foreach_sub_(ps, torch._foreach_mul(vs, lr))
    return losses


def make_train_step(cfg: ModelConfig, image_size: int, group=None):
    """One SGD step: ``step(state, batch, draws=None) -> metrics`` updates
    the state in place (parameters, velocity, step) and returns the loss
    dict and ``lr`` as 0-d tensors. ``draws`` are the global batch's
    (B·world rows; default: the step's generator,
    :func:`step_generator`). The update is the reference's, in float32:
    g + wd·p; v = m·v + g; p = p − lr·v, on every non-frozen leaf (biases
    included); frozen leaves and their velocity stay as they are.

    With ``group`` the batch is this rank's rows of the global batch
    (``parallel.mesh.shard_batch``), the gradients are summed over the
    ranks before the update and the metrics are the global batch's (the
    ranks' shares summed)."""
    world, rank = (group.world, group.rank) if group is not None else (1, 0)

    def step_fn(state: dict, batch: dict, draws: dict | None = None):
        ps, vs = _trainable(state, cfg)
        B, G = batch["gt_boxes"].shape[:2]
        if draws is None:
            draws = draw_uniforms(cfg, image_size, B * world, G,
                                  step_generator(state["seed"],
                                                 state["step"],
                                                 batch["image"].device))
        draws = {k: v[rank * B:(rank + 1) * B] for k, v in draws.items()}
        lr = lr_schedule(state["step"], cfg)
        losses = _sgd_step(cfg, image_size, state["params"], ps, vs, batch,
                           draws, lr, group)
        state["step"] += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        if group is not None:
            metrics = dict(zip(metrics, group.all_reduce(
                [torch.stack(list(metrics.values()))])[0].unbind()))
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        return metrics

    return step_fn


@functools.lru_cache(maxsize=16)
def train_step(cfg: ModelConfig, image_size: int, group=None):
    """The step of (cfg, image size, group), made once a process: repeated
    trainings (resumed runs, tests) share it."""
    return make_train_step(cfg, image_size, group)


def _stacked_draws(cfg: ModelConfig, image_size: int, state: dict, k: int,
                   B: int, G: int, device) -> dict:
    """The uniforms of the state's next k steps, (k, B, n) each: step s's
    from :func:`step_generator` (seed, s), what a single step draws."""
    per_step = [draw_uniforms(cfg, image_size, B, G, step_generator(
        state["seed"], state["step"] + i, device)) for i in range(k)]
    return {name: torch.stack([d[name] for d in per_step])
            for name in per_step[0]}


def _clone_state(state: dict) -> dict:
    """Parameters and velocity copied, each parameter requiring a gradient
    as its original does."""
    return {"params": tree_map(lambda _, t: t.detach().clone()
                               .requires_grad_(t.requires_grad),
                               state["params"]),
            "velocity": tree_map(lambda _, t: t.clone(), state["velocity"])}


class _TrainGraph:
    """k SGD steps of one state captured into one CUDA graph, their
    batches, uniforms and learning rates read from static buffers
    (``batches``, ``draws``: (k, ...) each; ``lr``: (k,) float32) that
    :meth:`load` fills. The capture's warm-up reads the first inputs,
    loaded before it, on a copy of the state, which stays as it is for
    the replays."""

    def __init__(self, cfg, image_size, k, state, batches, draws, lrs,
                 device):
        self.batches = {n: torch.empty_like(v, device=device)
                        for n, v in batches.items()}
        self.draws = {n: torch.empty_like(v, device=device)
                      for n, v in draws.items()}
        self.lr = torch.zeros(k, dtype=torch.float32, device=device)
        self.state_key = storage_key((state["params"], state["velocity"]))
        self.load(batches, draws, lrs)

        def step(target, i):
            ps, vs = _trainable(target, cfg)
            return _sgd_step(cfg, image_size, target["params"], ps, vs,
                             {n: v[i] for n, v in self.batches.items()},
                             {n: v[i] for n, v in self.draws.items()},
                             self.lr[i])

        def body():
            for i in range(k):
                losses = step(state, i)
            return {n: v.detach() for n, v in losses.items()}

        self.graph = CapturedGraph(body, lambda: step(_clone_state(state), 0),
                                   device)

    def load(self, batches: dict, draws: dict, lrs: list):
        for n, v in batches.items():
            self.batches[n].copy_(v, non_blocking=True)
        for n, v in draws.items():
            self.draws[n].copy_(v)
        self.lr.copy_(torch.tensor(lrs, dtype=torch.float32))


def make_train_scan_step(cfg: ModelConfig, image_size: int, k: int,
                         group=None, device="cuda"):
    """k SGD steps in one host call, the reference's
    ``make_train_scan_step``: ``fn(state, batches, draws=None)`` updates
    the state in place as k calls of :func:`make_train_step`'s step would
    and returns the metrics of the last step. ``batches``: the batch dict's
    arrays stacked on a leading k axis, (k, B, ...); ``draws``: the k
    steps' uniforms stacked the same way (default: each step's from
    :func:`step_generator`, as a single step draws them). The state lives
    on ``device``.

    On a CUDA device the k steps are one CUDA graph (``_TrainGraph``):
    forward, ``torch.autograd.grad``, the poolers (K2, or K1 on the fast
    profile) with K5 in their backward, K3 and the ``_foreach`` update,
    captured at the first call for (B, G) and the state's tensors and
    replayed after that; the uniforms are drawn outside it into its static
    buffers (a generator called inside a capture is not advanced by its
    replays) and the learning rates are a device tensor of the k steps'.
    Elsewhere the k steps run in a loop with the same tensor learning rate,
    the plain version. One device only, as the reference's form has no
    mesh: a ``group`` raises."""
    if group is not None:
        raise ValueError("make_train_scan_step runs on one device; a "
                         "data-parallel group takes make_train_step")
    device = resolve_device(device)
    graphs: dict = {}

    def fn(state: dict, batches: dict, draws: dict | None = None) -> dict:
        batches = {n: torch.as_tensor(v) for n, v in batches.items()}
        if batches["image"].shape[0] != k:
            raise ValueError(f"{batches['image'].shape[0]} batches for a "
                             f"scan of {k}")
        B, G = batches["gt_boxes"].shape[1:3]
        if draws is None:
            draws = _stacked_draws(cfg, image_size, state, k, B, G, device)
        lrs = [lr_schedule(state["step"] + i, cfg) for i in range(k)]
        if device.type == "cuda":
            graph = graphs.get((B, G))
            if graph is None or graph.state_key != storage_key(
                    (state["params"], state["velocity"])):
                graphs.pop((B, G), None)
                graph = _TrainGraph(cfg, image_size, k, state, batches,
                                    draws, lrs, device)
                graphs[(B, G)] = graph
            else:
                graph.load(batches, draws, lrs)
            graph.graph.replay()
            metrics = {n: v.clone() for n, v in graph.graph.outputs.items()}
        else:
            ps, vs = _trainable(state, cfg)
            for i in range(k):
                losses = _sgd_step(
                    cfg, image_size, state["params"], ps, vs,
                    {n: v[i].to(device) for n, v in batches.items()},
                    {n: v[i].to(device) for n, v in draws.items()},
                    torch.tensor(lrs[i], dtype=torch.float32))
            metrics = {n: v.detach() for n, v in losses.items()}
        state["step"] += k
        metrics["lr"] = torch.tensor(lrs[-1], dtype=torch.float32)
        return metrics

    fn.graphs = graphs
    return fn
