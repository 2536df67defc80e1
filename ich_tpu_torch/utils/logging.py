"""Logging / output-artifact helpers, copied from ``ich_tpu/utils/logging.py``
(importing ``ich_tpu`` imports jax): per-fold ``log.txt`` through a
root-logger FileHandler, ``outputs.json``, and a carriage-return progress
bar."""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any

LOG_FORMAT = "%(asctime)s | %(levelname)s | %(message)s"


def setup_logger(log_path: str | None = None, level: int = logging.INFO) -> logging.Logger:
    """Configure the root logger with stdout + optional file handler."""
    logger = logging.getLogger()
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fmt = logging.Formatter(LOG_FORMAT)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def save_json(path: str, payload: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def default(o):
        import numpy as np

        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(f"not JSON serializable: {type(o)}")

    with open(path, "w") as f:
        json.dump(payload, f, default=default)


def print_progressbar(n: int, total: int, name: str = "", size: int = 40, erase: bool = False) -> None:
    """Carriage-return progress bar (reference ``print_utils.py:12-36``)."""
    frac = (n + 1) / total
    filled = int(size * frac)
    bar = "█" * filled + "-" * (size - filled)
    end = "\r" if (n + 1) < total else ("\r" if erase else "\n")
    sys.stdout.write(f"{name} |{bar}| {n + 1}/{total}{end}")
    if (n + 1) == total and erase:
        sys.stdout.write(" " * (len(name) + size + 20) + "\r")
    sys.stdout.flush()
