"""Helpers of the pipeline stages (a copy of the reference package's
``utils/misc.py``): the CRS guard, the output-directory bootstrap and the
written-files manifest a stage logs at its end."""

from __future__ import annotations

import os
import sys

from .logging import logger


def ensure_dir_exists(dirpath: str) -> str:
    """mkdir-if-missing; returns the path."""
    if not os.path.exists(dirpath):
        os.makedirs(dirpath, exist_ok=True)
        logger.info(f"The directory {dirpath} was created.")
    return dirpath


def test_crs(crs1, crs2="EPSG:2056", *, strict: bool = True) -> None:
    """Exit with status 1 (``strict``) or raise ``ValueError`` unless the
    two CRS match. Takes CRS strings, ints, or objects with a ``.crs``."""
    c1 = getattr(crs1, "crs", crs1)
    c2 = getattr(crs2, "crs", crs2)
    n1, n2 = _norm_crs(c1), _norm_crs(c2)
    if n1 != n2:
        msg = f"CRS mismatch between the two files ({c1} vs {c2})."
        if strict:
            print(msg)
            sys.exit(1)
        raise ValueError(msg)


def _norm_crs(c) -> str:
    if c is None:
        return "none"
    s = str(c).upper().replace(" ", "")
    if s.isdigit():
        s = f"EPSG:{s}"
    return s


class Manifest:
    """Tracks the files a stage wrote; logged at the end of a run."""

    def __init__(self):
        self.files: list[str] = []

    def add(self, path: str) -> str:
        self.files.append(path)
        return path

    def log(self, log=logger) -> None:
        log.info("Written files:")
        for f in self.files:
            log.info(f)
