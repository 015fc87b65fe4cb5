"""Dual file+console logging, reference-compatible format.

The port's copy of ``yolofastest_tpu.utils.logging``: a logger with a file
handler and a console handler using the ``%(asctime)s——%(message)s`` format
of the reference's ``train.py:19-36`` / ``detect_dataset.py:18-35``, so the
port's detect logs read like the JAX package's.
"""

from __future__ import annotations

import logging
import os
from typing import Optional


def config_logger(log_dir: str, log_name: str, name: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name or f"yolofastest_torch.{log_name}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    os.makedirs(log_dir, exist_ok=True)
    formatter = logging.Formatter("%(asctime)s——%(message)s")
    fh = logging.FileHandler(os.path.join(log_dir, log_name), mode="w")
    fh.setFormatter(formatter)
    ch = logging.StreamHandler()
    ch.setFormatter(formatter)
    logger.addHandler(fh)
    logger.addHandler(ch)
    logger.propagate = False
    return logger


class LineLog:
    """A logger that keeps its ``info`` lines in ``lines`` (for callers that
    read back what the trainer or the evaluator logged)."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)
