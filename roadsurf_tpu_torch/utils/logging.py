"""The pipeline stages' logger: the reference package's ``utils/logging.py``
surface (``logger.info/success/warning/error`` on the standard library, one
line a record as ``2026-01-01 12:00:00 - INFO - message``, levels coloured
on a terminal).

Unlike the reference, importing this module changes no global of the
``logging`` package (the reference calls ``logging.setLoggerClass``): the
SUCCESS level's name is registered, and ``success`` is bound on the one
logger this module hands out.
"""

from __future__ import annotations

import functools
import logging
import sys

SUCCESS = 25
logging.addLevelName(SUCCESS, "SUCCESS")

_COLORS = {
    "SUCCESS": "\x1b[32m",   # green
    "WARNING": "\x1b[33m",   # yellow
    "ERROR": "\x1b[31m",     # red
    "CRITICAL": "\x1b[31m",  # red
}
_RESET = "\x1b[0m"


class _Formatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__(fmt="%(asctime)s - %(levelname)s - %(message)s",
                         datefmt="%Y-%m-%d %H:%M:%S")
        self._color = color

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        if self._color and record.levelname in _COLORS:
            c = _COLORS[record.levelname]
            ts, _, rest = line.partition(" - ")
            lvl, _, msg = rest.partition(" - ")
            if record.levelname in ("ERROR", "CRITICAL"):
                return f"{ts} - {c}{lvl}{_RESET} - {c}{msg}{_RESET}"
            return f"{ts} - {c}{lvl}{_RESET} - {msg}"
        return line


def get_logger(name: str = "roadsurf_tpu_torch.stages") -> logging.Logger:
    """The named logger with one stderr handler in the line format above,
    level INFO, and a ``success`` method (level 25). It does not propagate,
    so its name is no parent of the package's module loggers (which would
    then stop at it): ``roadsurf_tpu_torch.stages`` is a leaf."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter(color=sys.stderr.isatty()))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    if not hasattr(logger, "success"):
        logger.success = functools.partial(logger.log, SUCCESS)
    return logger


def format_logger(logger=None) -> logging.Logger:
    """The stages' logger, whatever is passed: the reference's alias of
    its ``fct_misc.format_logger``."""
    return get_logger()


logger = get_logger()
