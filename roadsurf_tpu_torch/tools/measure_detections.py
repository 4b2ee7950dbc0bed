"""Steady-state measurement of the end-to-end make_detections path: tile
files on disk -> decode -> device -> detections -> mask vectorisation ->
records, with trained or random weights.

    python -m roadsurf_tpu_torch.tools.measure_detections --images DIR
        [--ckpt FILE_OR_LOG_DIR] [--n-tiles 2048] [--batch 256] [--int8]
        [--scan-k 1] [--mask-format bits] [--from-scratch] [--profile]
        [--device cuda]

A port of the reference package's ``scripts/measure_detections.py``: the
GeoTIFF tiles of ``--images`` hard-linked (else copied) as
``{i:05d}.tif`` into a temporary directory, cycling until ``n_tiles``,
each with the bounds (0, 0, 256, 256); the fast profile
(``fast_profile()``) with weights from a checkpoint file or the newest of
a log directory, merged onto ``init_params`` seeded 0, or those random
weights alone; with ``int8`` the full int8 scope and the int8 pyramid,
calibrated once by ``prepare_quantized`` on 8 tiles spread over the list;
a warm-up of ``detect_tiles`` on one batch, then the timed ``detect_tiles``
over every tile at ``scan_k`` (CUDA graphs of ``scan_k`` forwards on the
card when above 1) with ``mask_format``. ``from_scratch`` scales the
inputs as ``tools.quality`` and ``tools.ablate_seeded`` train from
scratch (``pixel_std`` 57.375, 57.12, 58.395): the script runs
``fast_profile()``'s unit std whatever the checkpoint, so their weights
see inputs 57x too large there and fire almost nothing. The random
weights come from
``torch.Generator`` seed 0: torch cannot replay the reference's
``jax.random.PRNGKey(0)``, so a run without a checkpoint fires other
spurious detections than the reference's.

Prints and returns the script's JSON line (``metric``, ``tiles``,
``tiles_per_sec``, ``records``, ``elapsed_s``, unrounded) with the timed
call's stage split from ``detect_tiles(stats=...)`` (decode, h2d, d2h
and vectorise thread-seconds; detections at or above the threshold), the
settings and the device's name. ``profile`` runs the timed call under
``torch.profiler`` and adds the device's kernel seconds and busy share
(the profiler's own cost included in the wall). ``cfg`` replaces the
fast profile (the tests run narrow widths); ``records``, if given, gains
the timed call's records.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from ..io.geotiff import read_geotiff
from ..models.config import ModelConfig, fast_profile
from ..models.mask_rcnn import init_params
from ..models.quant import prepare_quantized
from ..pipeline import detections
from ..utils.d2_convert import merge_params
from ..utils.device import resolve_device
from ..utils.logging import logger
from ..utils.weights import from_jax_params, latest_checkpoint, load_params
from .quality import STD

CAL_TILES = 8                       # the int8 calibration's tiles
TILE_BOUNDS = (0.0, 0.0, 256.0, 256.0)


def replicate(images: str, n_tiles: int, work: str) -> list[str]:
    """``n_tiles`` paths ``work/{i:05d}.tif``, hard links (else copies) of
    the sorted GeoTIFFs of ``images`` in turn."""
    srcs = sorted(glob.glob(os.path.join(images, "*.tif")))
    if not srcs:
        raise FileNotFoundError(f"no tiles under {images}")
    paths = []
    for i in range(n_tiles):
        src, dst = srcs[i % len(srcs)], os.path.join(work, f"{i:05d}.tif")
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy(src, dst)
        paths.append(dst)
    return paths


def load_state(cfg: ModelConfig, ckpt: str | None) -> dict:
    """The forward's state: ``init_params`` seeded 0, with a checkpoint
    file or a log directory's newest checkpoint merged on."""
    tree = init_params(cfg, torch.Generator().manual_seed(0))
    if ckpt:
        if os.path.isdir(ckpt):
            ckpt = latest_checkpoint(ckpt)
        loaded, _ = load_params(ckpt)
        tree, _ = merge_params(tree, loaded)
        logger.info(f"weights: {ckpt}")
    return from_jax_params(tree)


def calibration_indices(n: int) -> np.ndarray:
    """The script's calibration tiles: 8 spread evenly over ``n``."""
    return np.unique(np.linspace(0, n - 1, CAL_TILES, dtype=int))


def _device_seconds(prof) -> float:
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            total += (e.self_cuda_time_total if us is None else us) / 1e6
    return total


def run(images: str, ckpt: str | None = None, n_tiles: int = 2048,
        batch: int = 256, int8: bool = False, scan_k: int = 1,
        mask_format: str = "bits", device="cuda",
        cfg: ModelConfig | None = None, profile: bool = False,
        records: list | None = None, from_scratch: bool = False) -> dict:
    """The measurement; returns its JSON line's dict. Raises when
    ``device`` names CUDA and no CUDA device is present."""
    dev = resolve_device(device)
    cfg = cfg or fast_profile()
    if from_scratch:
        cfg = replace(cfg, pixel_std=STD)
    work = tempfile.mkdtemp(prefix="det_bench_")
    try:
        paths = replicate(images, n_tiles, work)
        bounds = [TILE_BOUNDS] * len(paths)
        state = load_state(cfg, ckpt)
        if int8:
            # the full scope with the int8 pyramid, calibrated once up
            # front: a deployment's set-up, not a steady-state cost
            cfg = replace(cfg, int8_scope="full", int8_pyramid=True)
            cal = np.stack([read_geotiff(paths[i]).data[:, :, :3]
                            for i in calibration_indices(len(paths))])
            state["quant"] = prepare_quantized(state, cal, cfg, device=dev)
        kw = {"batch_size": batch, "scan_k": scan_k,
              "mask_format": mask_format, "device": dev}
        detections.detect_tiles(state, cfg, paths[:batch], bounds[:batch],
                                **kw)
        stats: dict = {}
        if profile:
            from torch.profiler import ProfilerActivity
            ctx = torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA])
        else:
            ctx = contextlib.nullcontext()
        with ctx as prof:
            t0 = time.perf_counter()
            recs = detections.detect_tiles(state, cfg, paths, bounds,
                                           stats=stats, **kw)
            dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line = {"metric": "make_detections_e2e", "tiles": n_tiles,
            "tiles_per_sec": n_tiles / dt, "records": len(recs),
            "elapsed_s": dt,
            "stages": {k: stats.get(k) for k in (
                "decode_s", "h2d_s", "d2h_s", "vectorize_s", "detections")},
            "batch": batch, "scan_k": scan_k, "int8": int8,
            "mask_format": mask_format, "weights": "checkpoint" if ckpt
            else "random", "from_scratch": from_scratch,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu"}
    if prof is not None:
        busy = _device_seconds(prof)
        line.update(device_s=busy, device_busy_share=busy / dt)
    if records is not None:
        records.extend(recs)
    print(json.dumps(line), flush=True)
    return line


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Times make_detections end to end over N copies of a "
                    "tile directory, with trained or random weights.")
    parser.add_argument("--images", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint file or log dir (default: random "
                             "init)")
    parser.add_argument("--n-tiles", type=int, default=2048)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--scan-k", type=int, default=1,
                        help="batches a dispatch (a CUDA graph of k "
                             "forwards on the card)")
    parser.add_argument("--mask-format", default="bits",
                        choices=("u8", "bits"),
                        help="mask downlink: thresholded bits packed on the "
                             "device, or u8 probabilities")
    parser.add_argument("--from-scratch", action="store_true",
                        help="scale the inputs as tools.quality and "
                             "tools.ablate_seeded train from scratch "
                             "(their pixel_std)")
    parser.add_argument("--profile", action="store_true",
                        help="time the measured call under torch.profiler "
                             "and report the device's busy share")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.images, args.ckpt, args.n_tiles, args.batch, args.int8,
        args.scan_k, args.mask_format, device=args.device,
        profile=args.profile, from_scratch=args.from_scratch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
