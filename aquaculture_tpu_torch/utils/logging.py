"""Structured logging of the PyTorch port (a copy of
aquaculture_tpu/utils/logging.py): a standard logging hierarchy under the
``aquaculture_tpu_torch`` root with the reference's ``[INFO]`` prefix
convention (reference: src/utils.py:210, src/utils_tonnage.py:652).
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(levelname)s] %(name)s: %(message)s"
_configured = False


def get_logger(name: str = "aquaculture_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("aquaculture_tpu_torch")
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(name)


def log_info(msg: str, *args) -> None:
    get_logger().info(msg, *args)


def log_warning(msg: str, *args) -> None:
    get_logger().warning(msg, *args)
