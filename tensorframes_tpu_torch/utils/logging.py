"""Logging shim: one logger hierarchy under ``tensorframes_tpu_torch``."""

import logging

_ROOT = "tensorframes_tpu_torch"


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
