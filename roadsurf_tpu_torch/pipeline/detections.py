"""make_detections: GeoTIFF tiles -> georeferenced detection polygons in a
GeoPackage, on one GPU or every visible one.

    python -m roadsurf_tpu_torch.pipeline.detections \\
        config/config_obj_detec.yaml [--batch-size 16] [--device cuda] \\
        [--n-devices N]

Port of the reference package's ``pipeline/detections.py``: for each
dataset's COCO tile list, decode the tiles on 8 threads behind a
``prefetch_iter(depth=2)``, run the detector through the engine in fixed
batches (the tail padded), and on a 4-thread pool paste each image's
instance masks into the tile, trace them into polygons in the tile's
EPSG:3857 frame, RDP-simplify them (ε = 0.75 m) and keep the records in
tile order; then write ``{ds}_detections_at_0dot05_threshold.gpkg`` in
EPSG:4326 with ``score`` and ``det_class``. The same int8 calibration
(≤ 8 tiles spread by ``np.linspace``, when the config asks and the state
has no quant tree), the same stage breakdown (decode, h2d, d2h and
vectorize thread-seconds).

With several devices the engine shards each batch over them (one replica
a device, ``engine/infer.py``), as the reference's engine does over its
mesh of ``jax.devices()``; ``n_devices`` defaults likewise to every
visible GPU (one device on the CPU).

Differences from the reference: no scan-k dispatch (one batch a
dispatch); the random weights
used when no checkpoint is found come from ``torch.Generator`` seed 0
(torch cannot reproduce ``jax.random``); the stage times can also be
handed back to the caller (``stats``). The records come from the C++
tracer, a copy of the reference's, so identical detections give identical
records.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import logging
import os
import threading
from time import perf_counter

import numpy as np
import torch

from ..geom.table import DetectionTable
from ..geom.vectorize import mask_to_polygons
from ..io.geotiff import read_geotiff
from ..io.gpkg import write_gpkg
from ..models import from_detectron2_yaml, init_params
from ..models.config import ModelConfig, fast_profile
from ..utils.config import load_script_config
from ..utils.d2_convert import merge_params
from ..utils.device import resolve_device
from ..utils.misc import Manifest
from ..utils.weights import from_jax_params, load_params

logger = logging.getLogger(__name__)


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray, size: int,
                thresh: float = 0.5) -> np.ndarray:
    """Paste per-detection mask probabilities into full-tile binary masks.

    mask_probs (D, M, M) in [0,1], boxes (D, 4) XYXY in tile pixels.
    detectron2 paste_masks_in_image semantics: bilinear grid-sample of the
    M×M mask over the box extent, align_corners=False, threshold 0.5.
    """
    D, M, _ = mask_probs.shape
    out = np.zeros((D, size, size), np.uint8)
    for d in range(D):
        x0, y0, x1, y1 = boxes[d]
        ix0, iy0 = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
        ix1, iy1 = min(int(np.ceil(x1)), size), min(int(np.ceil(y1)), size)
        if ix1 <= ix0 or iy1 <= iy0 or x1 <= x0 or y1 <= y0:
            continue
        xs = (np.arange(ix0, ix1) + 0.5 - x0) / (x1 - x0) * M - 0.5
        ys = (np.arange(iy0, iy1) + 0.5 - y0) / (y1 - y0) * M - 0.5
        xi = np.clip(xs, 0, M - 1)
        yi = np.clip(ys, 0, M - 1)
        xf = np.floor(xi).astype(int)
        yf = np.floor(yi).astype(int)
        xc = np.minimum(xf + 1, M - 1)
        yc = np.minimum(yf + 1, M - 1)
        wx = xi - xf
        wy = yi - yf
        m = mask_probs[d]
        top = m[yf][:, xf] * (1 - wx) + m[yf][:, xc] * wx
        bot = m[yc][:, xf] * (1 - wx) + m[yc][:, xc] * wx
        patch = top * (1 - wy)[:, None] + bot * wy[:, None]
        out[d, iy0:iy1, ix0:ix1] = (patch >= thresh).astype(np.uint8)
    return out


def vectorize_one(dets: dict, bi: int, bounds, tile_size: int = 256,
                  score_thresh: float = 0.05,
                  rdp_eps: float = 0.75) -> list[dict]:
    """The host stage of one image ``bi`` of a batch's detections (numpy
    arrays): paste the masks, trace, georeference, simplify. Returns its
    records {"geometry" (EPSG:3857), "score", "det_class"}. numpy and the
    C++ tracer release the GIL, so images run in parallel threads."""
    west, south, east, north = bounds
    sx = (east - west) / tile_size
    sy = (north - south) / tile_size
    valid = dets["valid"][bi] & (dets["scores"][bi] >= score_thresh)
    if not valid.any():
        return []
    boxes = dets["boxes"][bi][valid]
    scores = dets["scores"][bi][valid]
    classes = dets["classes"][bi][valid]
    if "mask_bits" in dets:
        # packed device-thresholded bits -> 0/1 "probabilities"; the 0.5
        # paste threshold then reduces to bilinear majority
        bits = dets["mask_bits"][bi][valid]
        probs = np.unpackbits(bits, axis=-1, bitorder="little") \
            .reshape(bits.shape[0], 28, 28).astype(np.float32)
    else:
        probs = dets["mask_probs_u8"][bi][valid].astype(np.float32) / 255.0
    bin_masks = paste_masks(probs, boxes, tile_size)

    def to_world(ring):
        out = np.empty_like(ring)
        out[:, 0] = west + ring[:, 0] * sx
        out[:, 1] = north - ring[:, 1] * sy
        return out

    recs = []
    for d in range(len(boxes)):
        for poly in mask_to_polygons(bin_masks[d], transform=to_world,
                                     simplify_eps=rdp_eps):
            recs.append({"geometry": poly, "score": float(scores[d]),
                         "det_class": int(classes[d])})
    return recs


def engine_devices(device, n_devices: int | None = None) -> list:
    """The engine's devices: ``device`` alone for one, else ``n_devices``
    CUDA devices ``cuda:0..n-1`` (default every visible GPU; more than
    are visible raise) or ``n_devices`` replicas on the CPU (default
    one)."""
    from ..parallel import default_world

    dev = resolve_device(device)
    n = n_devices or default_world(dev)
    if n == 1 or dev.type != "cuda":
        return [dev] * n
    if n > torch.cuda.device_count():
        raise ValueError(f"{n} devices asked for, "
                         f"{torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(n)]


def detect_tiles(state: dict, cfg: ModelConfig, image_paths: list[str],
                 tile_bounds: list, batch_size: int = 16,
                 score_thresh: float = 0.05, rdp_eps: float = 0.75,
                 tile_size: int = 256, progress_every: int = 50,
                 mask_format: str = "bits", device="cuda",
                 n_devices: int | None = None,
                 stats: dict | None = None) -> list[dict]:
    """Run inference over tile images; returns the per-detection records
    (geometry in EPSG:3857 of the tile bounds, score, det_class) in tile
    order. tile_bounds[i] = (west, south, east, north) in 3857 for image i.
    The engine shards each batch over ``n_devices`` devices
    (:func:`engine_devices`).
    ``stats``, if given, gains the stage breakdown: ``wall_s`` (this
    call), ``decode_s``, ``h2d_s``, ``d2h_s``, ``vectorize_s``
    (thread-seconds), and the counts ``tiles``, ``detections`` (valid, at
    or above the threshold) and ``records``."""
    from ..engine.infer import TileInferenceEngine, prefetch_iter

    t_call = perf_counter()
    want_int8 = cfg.int8_scope or ("backbone" if cfg.int8_backbone else "")
    if want_int8 and "quant" not in state and "backbone_q" not in state \
            and image_paths:
        # calibrate the static-int8 stack on real tiles sampled evenly
        # across the AOI (the first N paths can be all border/nodata tiles,
        # which would give unrepresentatively small activation scales)
        from ..models.quant import prepare_quantized
        idx = np.unique(np.linspace(0, len(image_paths) - 1,
                                    min(8, len(image_paths)), dtype=int))
        cal = np.stack([read_geotiff(image_paths[i]).data[:, :, :3]
                        for i in idx])
        state = dict(state)
        state["quant"] = prepare_quantized(state, cal, cfg, device=device)
        logger.info(f"int8 ({want_int8}): calibrated on {len(cal)} tiles")

    engine = TileInferenceEngine(state, cfg, batch_size=batch_size,
                                 with_masks=True, mask_format=mask_format,
                                 devices=engine_devices(device, n_devices))
    n = len(image_paths)
    stage_s = {"decode": 0.0, "vectorize": 0.0}
    lock = threading.Lock()

    def batches():
        # threaded tile decode (zlib releases the GIL) so the read stage
        # keeps pace with the device
        with cf.ThreadPoolExecutor(max_workers=8) as readers:
            for start in range(0, n, batch_size):
                t0 = perf_counter()
                chunk = image_paths[start:start + batch_size]
                imgs = list(readers.map(
                    lambda p: read_geotiff(p).data[:, :, :3], chunk))
                stage_s["decode"] += perf_counter() - t0
                yield np.stack(imgs)

    def timed_vectorize(dets, bi, bounds):
        t0 = perf_counter()
        try:
            return vectorize_one(dets, bi, bounds, tile_size, score_thresh,
                                 rdp_eps)
        finally:
            with lock:
                stage_s["vectorize"] += perf_counter() - t0

    records = []
    idx = 0
    n_det = 0
    all_futs = []
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        # decode prefetch: the reader generator runs in its own thread so
        # disk/zlib work overlaps result drains instead of serializing
        # between dispatches
        for dets in engine.run(prefetch_iter(batches(), depth=2)):
            n_im = len(dets["scores"])
            start = idx
            n_det += int((dets["valid"]
                          & (dets["scores"] >= score_thresh)).sum())
            # don't block on the host stage here: blocking would stall the
            # device feed; futures resolve in order at the end
            all_futs.extend(
                pool.submit(timed_vectorize, dets, bi, tile_bounds[idx + bi])
                for bi in range(n_im))
            idx += n_im
            if progress_every and (start // batch_size) % progress_every == 0:
                logger.info(f"inference: {min(start + batch_size, n)}/{n} "
                            "tiles dispatched")
        for fut in all_futs:                 # in-order: deterministic output
            records.extend(fut.result())
    eng_stats = getattr(engine, "stats", {})
    logger.info(
        "make_detections stage breakdown: decode %.1fs, h2d %.1fs, "
        "d2h %.1fs, vectorize %.1fs (thread-seconds)" % (
            stage_s["decode"], eng_stats.get("h2d_s", 0.0),
            eng_stats.get("d2h_s", 0.0), stage_s["vectorize"]))
    if stats is not None:
        for k, v in (("wall_s", perf_counter() - t_call),
                     ("decode_s", stage_s["decode"]),
                     ("h2d_s", eng_stats.get("h2d_s", 0.0)),
                     ("d2h_s", eng_stats.get("d2h_s", 0.0)),
                     ("vectorize_s", stage_s["vectorize"]), ("tiles", idx),
                     ("detections", n_det), ("records", len(records))):
            stats[k] = stats.get(k, 0) + v
    return records


def detect_dataset(state: dict, cfg: ModelConfig, coco: dict,
                   images_dir: str, img_metadata: dict,
                   **kw) -> DetectionTable:
    """Detect over one dataset's COCO images; returns detections in 3857
    (no records: the reference's empty frame, object columns)."""
    paths, bounds = [], []
    for im in coco["images"]:
        meta = img_metadata[im["file_name"]]
        paths.append(os.path.join(images_dir, im["file_name"]))
        bounds.append(meta["bounds_3857"])
    records = detect_tiles(state, cfg, paths, bounds, **kw)
    return DetectionTable.from_records(records, 3857)


def run(cfg: dict, model_cfg: ModelConfig | None = None,
        batch_size: int = 16, mask_format: str = "bits", device="cuda",
        n_devices: int | None = None,
        stats: dict | None = None) -> list[str]:
    """Execute the ``make_detections.py`` YAML block; returns the written
    files. Raises when ``device`` names CUDA and no CUDA device is
    present. The engine shards each batch over ``n_devices`` devices
    (default: every visible GPU). ``stats``, if given, gains the stage
    breakdown summed over the datasets."""
    device = resolve_device(device)
    wd = cfg["working_directory"]
    manifest = Manifest()

    if model_cfg is None:
        d2_yaml = os.path.join(wd, cfg["detectron2_config_file"])
        model_cfg = (from_detectron2_yaml(d2_yaml)
                     if os.path.exists(d2_yaml) else fast_profile())

    ckpt = os.path.join(wd, cfg["model_weights"]["pth_file"])
    init = init_params(model_cfg, torch.Generator().manual_seed(0))
    if os.path.exists(ckpt):
        loaded, _ = load_params(ckpt)
        tree, _ = merge_params(init, loaded)
        logger.info(f"loaded weights from {ckpt}")
    else:
        # also accept a native .npz next to the pinned .pth name
        alt = os.path.splitext(ckpt)[0] + ".npz"
        if os.path.exists(alt):
            loaded, _ = load_params(alt)
            tree, _ = merge_params(init, loaded)
            logger.info(f"loaded weights from {alt}")
        else:
            logger.warning(f"checkpoint {ckpt} not found; random weights")
            tree = init
    state = from_jax_params(tree)

    score_thresh = float(cfg.get("score_lower_threshold", 0.05))
    rdp = cfg.get("rdp_simplification", {}) or {}
    rdp_eps = float(rdp.get("epsilon", 0.75)) if rdp.get("enabled", True) \
        else 0.0

    with open(os.path.join(wd, cfg["image_metadata_json"])) as f:
        img_meta = json.load(f)

    thr_tag = str(score_thresh).replace(".", "dot")
    for ds, coco_rel in cfg["COCO_files"].items():
        coco_path = os.path.join(wd, coco_rel)
        if not os.path.exists(coco_path):
            logger.warning(f"{coco_path} absent; skipping {ds}")
            continue
        with open(coco_path) as f:
            coco = json.load(f)
        images_dir = os.path.join(wd, f"{ds}-images")
        table = detect_dataset(state, model_cfg, coco, images_dir, img_meta,
                               batch_size=batch_size,
                               score_thresh=score_thresh, rdp_eps=rdp_eps,
                               mask_format=mask_format, device=device,
                               n_devices=n_devices, stats=stats)
        table_4326 = table.to_crs(4326) if len(table) else table
        p = os.path.join(wd, f"{ds}_detections_at_{thr_tag}_threshold.gpkg")
        write_gpkg(table_4326, p, layer=f"{ds}_detections")
        manifest.add(p)
        logger.info(f"{ds}: {len(table)} detections")

    manifest.log()
    return manifest.files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Runs Mask R-CNN inference over the generated tilesets "
                    "and writes georeferenced detection polygons.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                             "versions")
    parser.add_argument("--n-devices", type=int, default=None,
                        help="devices the engine shards each batch over "
                             "(default: every visible GPU)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    tic = perf_counter()
    logger.info(f"Using {args.config_file} as config file.")
    cfg = load_script_config(args.config_file, "make_detections.py")
    run(cfg, batch_size=args.batch_size, device=args.device,
        n_devices=args.n_devices)
    logger.info(f"Done. Elapsed time: {perf_counter() - tic:.2f} seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
