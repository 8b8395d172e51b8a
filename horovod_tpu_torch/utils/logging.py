"""Leveled logging (counterpart of ``horovod_tpu/utils/logging.py``; the
port's own copy; ref: horovod/common/logging.{h,cc} — glog-style levels
selected by HOROVOD_LOG_LEVEL, timestamps toggled by HOROVOD_LOG_TIMESTAMP)."""
from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("horovod_tpu_torch")
        level = os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower()
        _logger.setLevel(_LEVELS.get(level, logging.WARNING))
        if not _logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            if os.environ.get("HOROVOD_LOG_TIMESTAMP"):
                fmt = "[%(asctime)s %(levelname)s %(name)s] %(message)s"
            else:
                fmt = "[%(levelname)s %(name)s] %(message)s"
            h.setFormatter(logging.Formatter(fmt))
            _logger.addHandler(h)
        _logger.propagate = False
    return _logger
