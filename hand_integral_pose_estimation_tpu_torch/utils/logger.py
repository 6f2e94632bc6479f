"""Coloured console + file logger.

A copy of hand_integral_pose_estimation_tpu/utils/logger.py (the
reference's common/logger.py:16-34): the same format, ANSI colours only
when stderr is a TTY, level INFO, no propagation, the file opened in
append mode. One difference: the JAX package caches the logger under
`name:log_name` whatever `log_dir` is, so a second runner in the process
writes into the first one's file (or into none). Here a logger is keyed by
the absolute path of its file, or by `name` alone when there is no file:
each `log_dir` gets its own file, and a call without one never reuses a
file handler.
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"
FORMAT = "%(asctime)s %(levelname)s %(message)s"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if sys.stderr.isatty() else msg


def color_logger(log_dir: str | None = None,
                 log_name: str = "train_logs.txt",
                 name: str = "hipe") -> logging.Logger:
    """Console (ANSI-coloured when a TTY) + append-mode file handler on
    `log_dir/log_name`; console only without `log_dir`."""
    path = (os.path.abspath(os.path.join(log_dir, log_name))
            if log_dir else None)
    logger = logging.getLogger(f"{name}:{path}" if path else name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False

    sh = logging.StreamHandler()
    sh.setFormatter(_ColorFormatter(FORMAT, datefmt="%H:%M:%S"))
    logger.addHandler(sh)

    if path:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(path, mode="a")
        fh.setFormatter(logging.Formatter(FORMAT))
        logger.addHandler(fh)
    return logger
