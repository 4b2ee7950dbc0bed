"""train_model: Mask R-CNN training over the COCO tilesets, on one GPU or
data-parallel over every visible one.

    python -m roadsurf_tpu_torch.pipeline.training \\
        config/config_obj_detec.yaml [--max-iter N] [--batch-size B] \\
        [--device cuda] [--n-devices N] [--backend nccl|gloo]

Port of the reference package's ``pipeline/training.py`` (its
``scripts/train_model.py``): the ``train_model.py`` block of the YAML
config, the detectron2 YAML's model and solver (SGD momentum 0.9, BASE_LR
0.01, WarmupMultiStepLR, IMS_PER_BATCH 8, checkpoint every
CHECKPOINT_PERIOD, eval every EVAL_PERIOD), and the reference's loader:
tiles at native resolution, padded ground truth with full-tile instance
bitmaps rasterized on the host (``geom_rasterize`` of ``csrc/geomcore.cpp``,
a copy of the reference's C++ fill), a random flip, then either the multiscale resize to
one MIN_SIZE_TRAIN choice per batch or the scale-jitter crop, and a
background prefetch thread. Every ``eval_period`` steps the validation
loss and the COCO AP of ``engine/coco_eval.py``; every
``checkpoint_period`` steps ``model_{it:07d}.npz`` in the reference's
schema; ``metrics.jsonl`` with the reference's keys, and TensorBoard
events where ``torch.utils.tensorboard`` imports.

Differences from the reference: the resizes are Pillow's, reproduced
without Pillow (``pipeline/resize.py``; the card's installation has none),
byte for byte; the training step is ``engine/train.py``'s, its sampling
draws from a ``torch.Generator`` seeded from (seed, step), and the random
initial weights from ``torch.Generator`` seed ``seed`` (torch cannot
reproduce ``jax.random``).

Data parallelism (``n_devices`` ranks, default every visible GPU as the
reference's default is every device): one process a rank
(``parallel/mesh.py``; NCCL on CUDA, gloo on the CPU or when asked for),
the reference's global-batch step (``engine/train.py``). Every rank runs
the same ``Prefetcher`` over the whole batch (same seed, same multiscale
size) and keeps its rows ``[r·b, (r+1)·b)``, so a rank's batch is byte
for byte its share of the one-process batch. Rank 0 alone writes the
eval, the checkpoints and ``metrics.jsonl`` while the others wait at a
barrier; every rank resumes from the newest checkpoint.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import threading
import time
from dataclasses import replace

import numpy as np
import torch

from ..engine.coco_eval import evaluate_dataset
from ..engine.train import compute_losses, draw_uniforms, init_train_state, \
    train_step, tree_map
from ..geom import _native as N
from ..io.geotiff import read_geotiff
from ..models import from_detectron2_yaml, init_params
from ..models.config import ModelConfig
from ..parallel import default_world, launch, replicate, shard_batch
from ..utils.config import load_script_config
from ..utils.d2_convert import merge_params
from ..utils.device import resolve_device
from ..utils.weights import fold_train_params, from_jax_train_params, \
    latest_checkpoint, load_params, save_params, to_jax_params
from .resize import resize_bilinear, resize_nearest

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# COCO dataset -> fixed-shape samples

class CocoTileDataset:
    """A COCO tileset (images + polygon annotations) in index form;
    samples are materialized on demand."""

    def __init__(self, coco_path: str, images_dir: str,
                 max_instances: int = 16):
        with open(coco_path) as f:
            coco = json.load(f)
        self.images_dir = images_dir
        self.max_instances = max_instances
        self.images = coco["images"]
        self.anns_by_image: dict[int, list] = {}
        for ann in coco["annotations"]:
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        # category_id is 1-based in COCO; det classes are 0-based
        self.cat_to_class = {c["id"]: i for i, c in
                             enumerate(sorted(coco["categories"],
                                              key=lambda c: c["id"]))}

    def __len__(self):
        return len(self.images)

    def load(self, idx: int):
        """Returns (image HWC uint8, boxes (G, 4), classes (G,), valid (G,),
        masks (G, H, W) uint8) padded to max_instances."""
        info = self.images[idx]
        r = read_geotiff(os.path.join(self.images_dir, info["file_name"]))
        img = r.data[:, :, :3]
        H, W = img.shape[:2]
        G = self.max_instances
        boxes = np.zeros((G, 4), np.float32)
        classes = np.zeros((G,), np.int32)
        valid = np.zeros((G,), bool)
        masks = np.zeros((G, H, W), np.uint8)
        anns = self.anns_by_image.get(info["id"], [])[:G]
        for i, ann in enumerate(anns):
            x, y, w, h = ann["bbox"]
            boxes[i] = (x, y, x + w, y + h)
            classes[i] = self.cat_to_class[ann["category_id"]]
            valid[i] = True
            rings = [np.asarray(ring, np.float64).reshape(-1, 2)
                     for ring in ann["segmentation"]]
            flat = N.pack([[_close(r) for r in rings]])
            N.rasterize(flat, 0.0, 1.0, 0.0, 1.0, H, W, out=masks[i])
        return img, boxes, classes, valid, masks


def _close(ring: np.ndarray) -> np.ndarray:
    if len(ring) and not np.array_equal(ring[0], ring[-1]):
        ring = np.concatenate([ring, ring[:1]])
    return ring


# ---------------------------------------------------------------------------
# augmentation (host, numpy)

def _resize_masks(masks, w: int, h: int):
    """Pillow's NEAREST resize of each (m·255) bitmap, //255."""
    return resize_nearest(masks * 255, w, h) // 255


def resize_sample(img, boxes, masks, target: int):
    """detectron2 ResizeShortestEdge for square tiles: bilinear image
    resize to target x target, nearest for masks, boxes scaled."""
    H, W = img.shape[:2]
    if H == target and W == target:
        return img, boxes, masks
    sy, sx = target / H, target / W
    img = resize_bilinear(img, target, target)
    if masks.shape[0]:
        masks = _resize_masks(masks, target, target)
    else:
        masks = np.zeros((0, target, target), masks.dtype)
    scale = np.asarray([sx, sy, sx, sy], np.float32)  # XYXY box layout
    return img, (boxes * scale).astype(np.float32), masks


def augment_sample(rng: np.random.Generator, img, boxes, classes, valid,
                   masks, scale_range=(0.8, 1.25), target_size=None):
    """Random horizontal flip, then either the multiscale resize
    (``target_size`` set: a MIN_SIZE_TRAIN choice) or the fixed-shape scale
    jitter with a crop or pad back to the native size; the reference's
    draws from ``rng`` in its order."""
    H, W = img.shape[:2]
    if rng.random() < 0.5:
        img = img[:, ::-1]
        masks = masks[:, :, ::-1]
        flipped = boxes.copy()
        flipped[:, 0] = W - boxes[:, 2]
        flipped[:, 2] = W - boxes[:, 0]
        boxes = flipped
    if target_size is not None:
        img, boxes, masks = resize_sample(img, boxes, masks, target_size)
        return img, boxes, classes, valid, masks
    s = rng.uniform(*scale_range)
    if abs(s - 1.0) > 1e-3:
        nh, nw = max(int(round(H * s)), 1), max(int(round(W * s)), 1)
        img_r = resize_bilinear(img, nw, nh)
        masks_r = _resize_masks(masks, nw, nh) if masks.shape[0] else masks
        boxes = boxes * s
        if s >= 1.0:   # random crop back to (H, W)
            oy = rng.integers(0, nh - H + 1)
            ox = rng.integers(0, nw - W + 1)
            img = img_r[oy:oy + H, ox:ox + W]
            masks = masks_r[:, oy:oy + H, ox:ox + W]
            boxes = boxes - [ox, oy, ox, oy]
        else:          # pad to (H, W)
            img = np.zeros((H, W, img.shape[2]), img.dtype)
            img[:nh, :nw] = img_r
            m2 = np.zeros((masks.shape[0], H, W), masks.dtype)
            m2[:, :nh, :nw] = masks_r
            masks = m2
        boxes = np.clip(boxes, 0, [W, H, W, H]).astype(np.float32)
        # drop degenerate boxes
        degen = (boxes[:, 2] - boxes[:, 0] < 1) | \
            (boxes[:, 3] - boxes[:, 1] < 1)
        valid = valid & ~degen
    return img, boxes.astype(np.float32), classes, valid, masks


# ---------------------------------------------------------------------------
# batching + prefetch

def make_batch(ds: CocoTileDataset, rng: np.random.Generator,
               indices: np.ndarray, augment: bool = True,
               target_size: int | None = None) -> dict:
    imgs, bs, cs, vs, ms = [], [], [], [], []
    for i in indices:
        sample = ds.load(int(i))
        if augment:
            sample = augment_sample(rng, *sample, target_size=target_size)
        elif target_size is not None:
            img, b, c, v, m = sample
            img, b, m = resize_sample(img, b, m, target_size)
            sample = (img, b, c, v, m)
        img, b, c, v, m = sample
        imgs.append(img)
        bs.append(b)
        cs.append(c)
        vs.append(v)
        ms.append(m)
    return {"image": np.stack(imgs), "gt_boxes": np.stack(bs),
            "gt_classes": np.stack(cs), "gt_valid": np.stack(vs),
            "gt_masks": np.stack(ms)}


class Prefetcher:
    """Background-thread batch producer (double-buffered host feed), the
    reference's order of samples and draws."""

    def __init__(self, ds: CocoTileDataset, batch_size: int, seed: int = 0,
                 depth: int = 2, augment: bool = True,
                 sizes: tuple | None = None):
        self.ds = ds
        self.batch_size = batch_size
        self.augment = augment
        self.sizes = sizes        # multiscale: one random size per batch
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.rng = np.random.default_rng(seed)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            self._produce()
        except BaseException as e:   # surface loader failures to next()
            self.q.put(e)

    def _produce(self):
        order = np.arange(len(self.ds))
        pos = len(order)
        while not self.stop.is_set():
            idx = []
            while len(idx) < self.batch_size:
                if pos >= len(order):
                    self.rng.shuffle(order)
                    pos = 0
                idx.append(order[pos])
                pos += 1
            target = (int(self.rng.choice(self.sizes))
                      if self.sizes else None)
            batch = make_batch(self.ds, self.rng, np.asarray(idx),
                               self.augment, target_size=target)
            while not self.stop.is_set():
                try:
                    self.q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        item = self.q.get()
        if isinstance(item, BaseException):
            raise RuntimeError("prefetcher worker failed") from item
        return item

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)


def to_device(batch: dict, device) -> dict:
    """A host batch as tensors on ``device`` (classes int64)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    out["gt_classes"] = out["gt_classes"].long()
    return out


# ---------------------------------------------------------------------------
# training loop

def train(cfg: ModelConfig, trn_coco: str, trn_images: str, log_dir: str,
          val_coco: str | None = None, val_images: str | None = None,
          max_iter: int | None = None, batch_size: int | None = None,
          image_size: int = 256, max_instances: int = 16,
          init_checkpoint: str | None = None, log_every: int = 20,
          seed: int = 7, multiscale: bool | None = None,
          device="cuda", group=None) -> dict:
    """Run the training loop on ``device``; returns the final train state
    (``engine.train.init_train_state``'s, on the device). Raises when
    ``device`` names CUDA and no CUDA device is present.

    ``multiscale`` as in the reference: None derives it from the config's
    INPUT block (on iff ``image_size`` is one of several MIN_SIZE_TRAIN
    choices); each batch then is resized to one of ``cfg.min_size_train``.

    ``group`` (``parallel.mesh.DataParallelGroup``): this process is one
    rank of a data-parallel run on the group's device; ``batch_size`` is
    the global batch, which the ranks split.
    """
    dev = group.device if group is not None else resolve_device(device)
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    lead = rank == 0
    os.makedirs(log_dir, exist_ok=True)
    max_iter = max_iter or cfg.max_iter
    batch_size = batch_size or cfg.ims_per_batch
    if batch_size % world:
        raise ValueError(f"batch {batch_size} does not split over {world} "
                         "ranks")

    ds = CocoTileDataset(trn_coco, trn_images, max_instances)
    if not len(ds):
        raise ValueError(f"empty training set: {trn_coco}")
    logger.info(f"training on {len(ds)} tiles, batch {batch_size}, "
                f"{max_iter} iters")

    tree = init_params(cfg, torch.Generator().manual_seed(seed))
    start_iter = 0
    resume = latest_checkpoint(log_dir)
    if resume:
        # a run restarted on the same log dir resumes from its newest
        # checkpoint
        loaded, step0 = load_params(resume)
        tree, _ = merge_params(tree, loaded)
        start_iter = step0 or 0
        logger.info(f"resuming from {resume} at iter {start_iter}")
    elif init_checkpoint and os.path.exists(init_checkpoint):
        loaded, _ = load_params(init_checkpoint)
        tree, _ = merge_params(tree, loaded)
        logger.info(f"warm start from {init_checkpoint}")
    state = init_train_state(from_jax_train_params(tree), cfg, seed=seed,
                             device=dev)
    state["step"] = start_iter
    if group is not None:
        # every rank starts from rank 0's parameters, bit for bit; and no
        # rank reads the log dir's checkpoints after rank 0 may write one
        replicate(state["params"], group)
        group.barrier()

    if multiscale is None:
        choices = set(cfg.min_size_train)
        multiscale = len(choices) > 1 and image_size in choices
    sizes = tuple(cfg.min_size_train) if multiscale else (image_size,)

    feeder = Prefetcher(ds, batch_size, seed=seed,
                        sizes=sizes if multiscale else None)
    val_feeder = None
    val_ds = None
    if lead and val_coco and os.path.exists(val_coco):
        val_ds = CocoTileDataset(val_coco, val_images, max_instances)
        if len(val_ds):
            val_feeder = Prefetcher(val_ds, batch_size, seed=99,
                                    augment=False, sizes=(image_size,))
        else:
            val_ds = None

    mf = open(os.path.join(log_dir, "metrics.jsonl"), "a") if lead \
        else None
    tb = None
    try:        # TensorBoard events like the reference trainer (optional)
        from torch.utils.tensorboard import SummaryWriter
        tb = SummaryWriter(log_dir) if lead else None
    except ImportError:
        pass

    def emit(tag_values: dict, it: int):
        mf.write(json.dumps(dict(tag_values, iter=it)) + "\n")
        mf.flush()
        if tb is not None:
            for k, v in tag_values.items():
                if isinstance(v, (int, float)):
                    tb.add_scalar(k, v, it)

    def val_loss(batch: dict) -> dict:
        """The validation losses, with fixed draws from seed 0."""
        B, G = batch["gt_boxes"].shape[:2]
        S = batch["image"].shape[1]
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        with torch.no_grad():
            return compute_losses(state["params"], batch,
                                  draw_uniforms(cfg, S, B, G, g), cfg, S)

    # COCO-style AP at eval_period, inference at the training tile size
    eval_cfg = replace(cfg, min_size_test=image_size,
                       max_size_test=image_size)
    samples_dir = os.path.join(log_dir, "samples")

    def detection_eval(it: int) -> dict:
        ap = evaluate_dataset(fold_train_params(state["params"]), eval_cfg,
                              val_ds, image_size, batch_size=batch_size,
                              viz_dir=samples_dir, viz_count=4,
                              viz_tag=f"{it:06d}", device=dev)
        return {f"val_{k}": v for k, v in ap.items()}

    t0 = time.time()
    try:
        for it in range(start_iter, max_iter):
            batch = feeder.next()
            if group is not None:
                batch = shard_batch(batch, rank, world)
            batch = to_device(batch, dev)
            metrics = train_step(cfg, batch["image"].shape[1], group)(
                state, batch)

            if lead and ((it + 1) % log_every == 0 or it == 0):
                m = {k: float(v) for k, v in metrics.items()}
                m["imgs_per_sec"] = round(
                    batch_size * min(it + 1, log_every)
                    / max(time.time() - t0, 1e-9), 2)
                t0 = time.time()
                emit(m, it + 1)
                logger.info(f"iter {it + 1}/{max_iter} "
                            f"total={m['total']:.3f} lr={m['lr']:.5f} "
                            f"({m['imgs_per_sec']} img/s)")

            eval_step = (it + 1) % cfg.eval_period == 0
            if val_feeder is not None and eval_step:
                vb = to_device(val_feeder.next(), dev)
                v = {f"val_{k}": float(x) for k, x in val_loss(vb).items()}
                v.update(detection_eval(it + 1))
                emit(v, it + 1)
                logger.info(f"eval @{it + 1}: val_total={v['val_total']:.3f}"
                            f" bbox_AP={v.get('val_bbox/AP')} "
                            f"segm_AP={v.get('val_segm/AP')}")

            save = (it + 1) % cfg.checkpoint_period == 0 \
                or it + 1 == max_iter
            if lead and save:
                p = os.path.join(log_dir, f"model_{it:07d}.npz")
                save_params(p, to_jax_params(state["params"]), step=it + 1)
                logger.info(f"checkpoint: {p}")
            if group is not None and (save or eval_step):
                group.barrier()     # the other ranks wait for rank 0
    finally:
        feeder.close()
        if val_feeder:
            val_feeder.close()
        if mf is not None:
            mf.close()
        if tb is not None:
            tb.close()
    return state


# ---------------------------------------------------------------------------
# the entry point: the ``train_model.py`` YAML block

def _train_rank(group, kwargs: dict):
    """A rank of :func:`run` (the launcher's entry function): ``train`` on
    this rank; rank 0 hands back its final state as numpy trees."""
    state = train(**kwargs, group=group)
    if group.rank:
        return None
    return {"params": tree_map(lambda _, t: t.detach().cpu().numpy(),
                               state["params"]),
            "velocity": tree_map(lambda _, t: t.detach().cpu().numpy(),
                                 state["velocity"]),
            "step": state["step"], "seed": state["seed"]}


def run(cfg: dict, max_iter: int | None = None,
        batch_size: int | None = None, n_devices: int | None = None,
        backend: str | None = None, log_every: int = 20, device="cuda",
        stats: dict | None = None) -> dict:
    """Execute the ``train_model.py`` YAML block; returns the final train
    state (of rank 0, on the CPU, when it ran data-parallel).

    ``n_devices`` ranks (default: every visible GPU; one on the CPU) run
    data-parallel in spawned processes, one a device, over ``backend``
    (NCCL on CUDA, gloo on the CPU; gloo lets several CUDA ranks share a
    card). One rank runs in this process unless a ``backend`` is named.
    ``stats``, if given, gains ``ranks``: each rank's kernel launches."""
    device = resolve_device(device)
    n = n_devices or default_world(device)
    wd = cfg["working_directory"]
    log_dir = os.path.join(wd, cfg.get("log_subfolder", "logs"))
    model_cfg = from_detectron2_yaml(os.path.join(
        wd, cfg["detectron2_config_file"]))

    coco = cfg["COCO_files"]
    trn = os.path.join(wd, coco["trn"])
    val = os.path.join(wd, coco.get("val", "")) if coco.get("val") else None

    init_ckpt = None
    mw = cfg.get("model_weights", {}) or {}
    url = mw.get("model_zoo_checkpoint_url", "")
    # a file only: without model_weights the second candidate is the
    # working directory itself (the reference then fails to load it)
    for cand in (url, os.path.join(wd, os.path.basename(str(url)))):
        if cand and os.path.isfile(str(cand)):
            init_ckpt = str(cand)
            break

    # the multiscale resize is on whenever the detectron2 YAML pins more
    # than one MIN_SIZE_TRAIN choice; ``multiscale: false`` opts into the
    # single-shape jitter-crop pipeline
    multiscale = bool(cfg.get("multiscale",
                              len(set(model_cfg.min_size_train)) > 1))
    image_size = int(cfg.get("image_size",
                             model_cfg.min_size_train[-1] if multiscale
                             else 256))
    kwargs = dict(cfg=model_cfg, trn_coco=trn,
                  trn_images=os.path.join(wd, "trn-images"),
                  log_dir=log_dir, val_coco=val,
                  val_images=os.path.join(wd, "val-images"),
                  max_iter=max_iter, batch_size=batch_size,
                  image_size=image_size, init_checkpoint=init_ckpt,
                  log_every=log_every, seed=int(cfg.get("seed", 7)),
                  multiscale=multiscale)
    if n == 1 and backend is None:
        return train(**kwargs, device=device)
    ranks = launch(_train_rank, n, kwargs, device=device, backend=backend)
    if stats is not None:
        stats["ranks"] = [{"launches": r["launches"]} for r in ranks]
    out = ranks[0]["result"]
    for k in ("params", "velocity"):
        out[k] = tree_map(lambda _, a: torch.from_numpy(a), out[k])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Trains the Mask R-CNN road-surface detector, "
                    "data-parallel over the visible GPUs.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    parser.add_argument("--max-iter", type=int, default=None,
                        help="override SOLVER.MAX_ITER")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="override SOLVER.IMS_PER_BATCH")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                             "versions")
    parser.add_argument("--n-devices", type=int, default=None,
                        help="data-parallel ranks, one a device (default: "
                             "every visible GPU)")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="the ranks' collectives (default: nccl on "
                             "CUDA, gloo on the CPU; gloo lets ranks share "
                             "a GPU)")
    parser.add_argument("--log-every", type=int, default=20,
                        help="steps between metrics.jsonl lines")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    tic = time.perf_counter()
    logger.info(f"Using {args.config_file} as config file.")
    cfg = load_script_config(args.config_file, "train_model.py")
    run(cfg, max_iter=args.max_iter, batch_size=args.batch_size,
        n_devices=args.n_devices, backend=args.backend,
        log_every=args.log_every, device=args.device)
    logger.info(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                f"seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
