"""Leveled logging for byteps_tpu_torch, driven by ``BYTEPS_LOG_LEVEL``
(TRACE, DEBUG, INFO, WARNING, ERROR, FATAL; default WARNING), as in the
JAX package and BytePS's BPS_LOG (logging.h:26,90-94)."""

from __future__ import annotations

import logging
import os
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "TRACE": TRACE,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
}


def _make_logger() -> logging.Logger:
    logger = logging.getLogger("byteps_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] BYTEPS %(levelname)s %(message)s"))
        logger.addHandler(handler)
    logger.propagate = False
    refresh_level(logger)
    return logger


def refresh_level(logger: logging.Logger = None) -> None:
    """Re-read BYTEPS_LOG_LEVEL (init() calls this, so a level set after
    import takes effect)."""
    level_name = os.environ.get("BYTEPS_LOG_LEVEL", "WARNING").upper()
    (logger or log).setLevel(_LEVELS.get(level_name, logging.WARNING))


log = _make_logger()
