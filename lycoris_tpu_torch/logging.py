"""Logging for lycoris_tpu_torch (a copy of lycoris_tpu/logging.py).

Mirrors the reference's colored logger + warn-once helpers
(reference: lycoris/logging.py:7-52) in a plain, dependency-free way.
"""

import functools
import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[38;5;245m",
    logging.INFO: "\x1b[38;5;39m",
    logging.WARNING: "\x1b[38;5;214m",
    logging.ERROR: "\x1b[38;5;196m",
    logging.CRITICAL: "\x1b[48;5;196m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        prefix = f"{color}[{record.levelname}]{_RESET}" if sys.stderr.isatty() else f"[{record.levelname}]"
        return f"{prefix} {record.name}: {record.getMessage()}"


logger = logging.getLogger("LyCORIS-TPU-torch")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(_ColorFormatter())
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False


@functools.cache
def info_once(msg: str):
    logger.info(msg)


@functools.cache
def warning_once(msg: str):
    logger.warning(msg)


@functools.cache
def error_once(msg: str):
    logger.error(msg)
