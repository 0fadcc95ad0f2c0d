"""Structured logging (the reference has printf-only observability).

Counterpart of matrix_fhe_tpu/utils/logging.py: one stderr handler a
logger, the level from MATRIX_FHE_LOG (INFO by default), no propagation.
"""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname).1s matrix_fhe_tpu_torch %(name)s] %(message)s"


def get_logger(name: str = "core") -> logging.Logger:
    logger = logging.getLogger(f"matrix_fhe_tpu_torch.{name}")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("MATRIX_FHE_LOG", "INFO"))
        logger.propagate = False
    return logger
