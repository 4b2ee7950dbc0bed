"""Object stores for the imagery preprocessing branch (a copy of the
reference package's ``io/objstore.py``).

tif2cog works against an S3-compatible store. ``LocalStore`` maps the same
key semantics onto a directory tree; ``S3Store`` binds to boto3, imported
only when one is made (boto3 need not be installed otherwise). All stores
share skip-if-exists upload semantics.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Iterator

logger = logging.getLogger(__name__)


class ProgressPercentage:
    """Thread-safe upload progress callback (reference
    RS_images_to_S3.py:99-116)."""

    def __init__(self, filename: str):
        self._filename = filename
        self._size = float(os.path.getsize(filename))
        self._seen = 0
        self._lock = threading.Lock()

    def __call__(self, bytes_amount: int):
        with self._lock:
            self._seen += bytes_amount
            pct = (self._seen / self._size) * 100 if self._size else 100.0
            logger.info(f"{self._filename}: {self._seen} / "
                        f"{self._size:.0f} ({pct:.2f}%)")


class ObjectStore:
    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def upload(self, local_path: str, key: str, callback=None) -> None:
        raise NotImplementedError

    def download(self, key: str, local_path: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str = "") -> Iterator[str]:
        raise NotImplementedError

    def upload_if_missing(self, local_path: str, key: str,
                          callback=None) -> bool:
        """Returns True if uploaded, False if skipped (already online)."""
        if self.exists(key):
            logger.info(f"{key} already online; skipped.")
            return False
        self.upload(local_path, key, callback=callback)
        return True


class LocalStore(ObjectStore):
    """Directory-tree store with S3-like keys."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.lstrip("/"))

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def upload(self, local_path: str, key: str, callback=None) -> None:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(local_path, dst)
        if callback:
            callback(os.path.getsize(local_path))

    def download(self, key: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        shutil.copy2(self._path(key), local_path)

    def open_path(self, key: str) -> str:
        """Local stores can be read in place (the /vsis3/ analogue)."""
        return self._path(key)

    def list(self, prefix: str = "") -> Iterator[str]:
        base = self._path(prefix)
        if not os.path.isdir(base):
            return
        for dirpath, _, files in os.walk(base):
            for f in sorted(files):
                full = os.path.join(dirpath, f)
                yield os.path.relpath(full, self.root)


class S3Store(ObjectStore):
    """boto3-backed store (requires boto3 + credentials; reference
    RS_images_to_S3.py / tif2cog.py behavior)."""

    def __init__(self, bucket: str, endpoint_url: str | None = None,
                 access_key: str | None = None,
                 secret_key: str | None = None):
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError(
                "boto3 is not installed; use LocalStore, or install boto3 "
                "for S3 access") from e
        self.bucket = bucket
        self.client = boto3.client(
            "s3", endpoint_url=endpoint_url,
            aws_access_key_id=access_key,
            aws_secret_access_key=secret_key)

    def exists(self, key: str) -> bool:
        try:
            self.client.head_object(Bucket=self.bucket, Key=key)
            return True
        except Exception:
            return False

    def upload(self, local_path: str, key: str, callback=None) -> None:
        self.client.upload_file(local_path, self.bucket, key,
                                Callback=callback)

    def download(self, key: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        self.client.download_file(self.bucket, key, local_path)

    def list(self, prefix: str = "") -> Iterator[str]:
        paginator = self.client.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=prefix):
            for item in page.get("Contents", []):
                yield item["Key"]


def make_store(cfg: dict) -> ObjectStore:
    """Build a store from config: {'type': 'local', 'root': ...} or
    {'type': 's3', 'bucket': ..., 'endpoint_url': ...} (credentials from the
    environment / .env like the reference, tif2cog.py:310-316)."""
    kind = cfg.get("type", "local")
    if kind == "local":
        return LocalStore(cfg["root"])
    if kind == "s3":
        return S3Store(cfg["bucket"], cfg.get("endpoint_url"),
                       access_key=os.environ.get("AWS_ACCESS_KEY_ID"),
                       secret_key=os.environ.get("AWS_SECRET_ACCESS_KEY"))
    raise ValueError(f"unknown store type {kind!r}")
