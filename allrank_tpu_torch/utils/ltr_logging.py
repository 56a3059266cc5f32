"""Run logging to stdout and ``<output_dir>/training.log`` (the JAX
package's ``utils/ltr_logging.py``)."""

from __future__ import annotations

import logging
import os
import sys


def init_logger(output_dir: str) -> logging.Logger:
    log_format = "[%(levelname)s] %(asctime)s - %(message)s"
    logging.basicConfig(format=log_format, datefmt="%Y-%m-%d %H:%M:%S",
                        stream=sys.stdout, level=logging.INFO)
    logger = logging.getLogger(__name__)
    logger.setLevel(logging.INFO)
    handler = logging.FileHandler(os.path.join(output_dir, "training.log"))
    handler.setLevel(logging.INFO)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.addHandler(handler)
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger(__name__)
