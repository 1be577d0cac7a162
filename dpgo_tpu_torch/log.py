"""Structured logging for dpgo_tpu_torch: the port's own copy of
dpgo_tpu/log.py, the counterpart of the reference's glog usage
(LOG(INFO/WARNING) + CHECK macros throughout).

One package-level logger, glog-style line format. Quiet by default (library
etiquette: a NullHandler); `enable(level)` turns on stderr output — the
examples and verbose agent paths call it. CHECK-style helpers raise with the
failed condition, mirroring glog's CHECK semantics.
"""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("dpgo_tpu_torch")
logger.addHandler(logging.NullHandler())


def enable(level: int = logging.INFO) -> None:
    """Attach a stderr handler with a glog-like format (idempotent)."""
    for h in logger.handlers:
        if getattr(h, "_dpgo_stderr", False):
            h.setLevel(level)
            logger.setLevel(level)
            return
    h = logging.StreamHandler(sys.stderr)
    h._dpgo_stderr = True
    h.setFormatter(
        logging.Formatter(
            "%(levelname).1s%(asctime)s.%(msecs)03d %(name)s] %(message)s",
            datefmt="%m%d %H:%M:%S",
        )
    )
    h.setLevel(level)
    logger.addHandler(h)
    logger.setLevel(level)


def check(cond, msg: str = "", *args) -> None:
    """glog CHECK: raise on a failed invariant (reference: CHECK/CHECK_*
    macros everywhere in src/)."""
    if not cond:
        raise AssertionError("CHECK failed: " + (msg % args if args else msg))


def info(msg: str, *args) -> None:
    logger.info(msg, *args)


def warning(msg: str, *args) -> None:
    logger.warning(msg, *args)


def debug(msg: str, *args) -> None:
    logger.debug(msg, *args)
