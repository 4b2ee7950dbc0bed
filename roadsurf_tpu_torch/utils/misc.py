"""The written-files manifest a pipeline stage logs at its end (a copy of
the reference package's ``utils/misc.py::Manifest``)."""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


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
