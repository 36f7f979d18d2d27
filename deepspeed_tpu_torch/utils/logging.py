"""The package logger.

Counterpart of ``deepspeed_tpu/utils/logging.py``. Only ``logger`` is
ported so far; the rank-aware helpers (``log_dist``, ``print_rank_0``)
come with the distributed slice. The level is read from
``DS_TPU_LOG_LEVEL`` (debug, info, warning, error, critical).
"""
import logging
import os
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def create_logger(name="DeepSpeedTPUTorch", level=logging.INFO):
    formatter = logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(level)
        ch.setFormatter(formatter)
        logger_.addHandler(ch)
    return logger_


logger = create_logger(
    level=log_levels.get(os.environ.get("DS_TPU_LOG_LEVEL", "info"), logging.INFO))
