"""RS_images_to_S3: the bulk upload of SWISSIMAGE-RS imagery to an object
store (a copy of the reference package's ``pipeline/upload.py``): glob the
local imagery and upload each file unless its key is already in the store
(resume), with a progress callback, plus the move and copy helpers. Runs on
the port's ``io/objstore.py``; ``local_store_root`` maps the flow onto a
directory store where there is no S3 (boto3 is not installed).

Entry point, the reference's ``scripts/RS_images_to_S3.py``: ``python -m
roadsurf_tpu_torch.pipeline.upload config/config_preprocessing.yaml`` (its
``RS_images_to_S3.py`` block).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import time

from ..io.objstore import ObjectStore, ProgressPercentage, make_store
from ..utils.config import load_script_config
from ..utils.logging import logger


def file_exists_online(store: ObjectStore, key: str) -> bool:
    return store.exists(key)


def upload_file(store: ObjectStore, local_path: str, key: str,
                progress: bool = True) -> bool:
    """Upload one file unless its key already exists in the store."""
    cb = ProgressPercentage(local_path) if progress else None
    return store.upload_if_missing(local_path, key, callback=cb)


def move_files(paths: list[str], dst_dir: str) -> list[str]:
    os.makedirs(dst_dir, exist_ok=True)
    out = []
    for p in paths:
        d = os.path.join(dst_dir, os.path.basename(p))
        shutil.move(p, d)
        out.append(d)
    return out


def copy_files(paths: list[str], dst_dir: str) -> list[str]:
    os.makedirs(dst_dir, exist_ok=True)
    out = []
    for p in paths:
        d = os.path.join(dst_dir, os.path.basename(p))
        shutil.copy2(p, d)
        out.append(d)
    return out


def run(cfg: dict, store: ObjectStore | None = None) -> list[str]:
    """Execute the ``RS_images_to_S3.py`` YAML block (datapath glob,
    bucket, outpath); returns the keys uploaded. A ``local_store_root`` key
    maps the same flow onto a directory store."""
    if store is None:
        if cfg.get("local_store_root"):
            store = make_store({"type": "local",
                                "root": cfg["local_store_root"]})
        else:
            store = make_store({"type": "s3", "bucket": cfg["bucket"],
                                "endpoint_url": cfg.get("url")})
    outpath = cfg.get("outpath", "").strip("/")
    uploaded = []
    paths = sorted(glob.glob(cfg["datapath"]))
    logger.info(f"{len(paths)} files matched {cfg['datapath']}")
    for p in paths:
        if not os.path.isfile(p):
            continue
        key = f"{outpath}/{os.path.basename(p)}" if outpath \
            else os.path.basename(p)
        if upload_file(store, p, key):
            uploaded.append(key)
    logger.info(f"{len(uploaded)} files uploaded, "
                f"{len(paths) - len(uploaded)} skipped.")
    return uploaded


def main(argv: list[str] | None = None) -> int:
    tic = time.perf_counter()
    parser = argparse.ArgumentParser(
        description="Uploads SWISSIMAGE-RS imagery to the object store "
                    "with skip-if-exists resume.")
    parser.add_argument("config_file", type=str, help="a YAML config file")
    args = parser.parse_args(argv)
    logger.info(f"Using {args.config_file} as config file.")
    run(load_script_config(args.config_file, "RS_images_to_S3.py"))
    logger.success(f"Done. Elapsed time: {time.perf_counter() - tic:.2f} "
                   "seconds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
