"""Logging: stdout and a file in the experiment directory, timestamped
(counterpart of contrastboundary_tpu/utils/logger.py): a standard
logging.Logger with two handlers. Across the ranks of a process group
every rank logs to stdout and rank 0 alone to the file.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

from ..parallel.mesh import process_index


def setup_logger(name: str = "cbl", log_file: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(levelname).1s] %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and process_index() == 0:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
