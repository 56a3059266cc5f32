"""Run logging through the standard library's ``logging``."""

from __future__ import annotations

import logging


def get_logger() -> logging.Logger:
    return logging.getLogger(__name__)
