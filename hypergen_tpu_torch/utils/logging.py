"""Stdout logging in the reference's format (reference:src/utils.rs:17-29):

    %Y-%m-%d-%H:%M:%S [LEVEL] - message
"""

from __future__ import annotations

import logging
import sys


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("hypergen")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                fmt="%(asctime)s [%(levelname)s] - %(message)s",
                datefmt="%Y-%m-%d-%H:%M:%S",
            )
        )
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger
