"""Structured logging (the reference has printf-only observability,
RayTracingOnCPU/scene.cpp:112,209-212, main.cpp:77,110-111): the logger
of ``tinyraytracing_tpu/utils/logging.py``, same name and format."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "tinypt") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger
